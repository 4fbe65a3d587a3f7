"""Research stack of the port, on the boxlcd_tpu_torch substrate (the
counterpart of the JAX package's `research/`): the batched envs, the goal
wrappers and the learned env (`research.wrappers`), the autoencoders and
video models (`research.nets`), metrics, the Trainer and Evaler
(`research.runners`), the collect/train/eval CLI (`research.main`), and the
RL chain: PPO, SAC and their CLI (`research.rl`) and `eval_policy`
(`research.scripts`)."""
