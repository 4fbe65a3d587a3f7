"""The RL chain of the port (the counterpart of the JAX package's
`research/rl/`): buffers, nets, PPO, SAC and the `ppo|sac` entry point."""
