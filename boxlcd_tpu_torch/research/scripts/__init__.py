"""Scripts of the port (the counterpart of the JAX package's
`research/scripts/`): `eval_policy`."""
