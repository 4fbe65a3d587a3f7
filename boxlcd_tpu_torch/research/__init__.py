"""Research stack of the port, on the boxlcd_tpu_torch substrate (the
counterpart of the JAX package's `research/`). Ported so far: the per-step
batched env and the goal wrappers (`research.wrappers`), and the world-model
chain: the BVAE and FBT models (`research.nets`), metrics, the Trainer
(`research.runners`) and the collect/train CLI (`research.main`)."""
