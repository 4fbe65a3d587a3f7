"""Scripts of the port (the counterpart of the JAX package's
`research/scripts/`): `eval_policy`, and the media makers `demo_gifs`,
`lcd_wave`, `sample_model` and `viz_goal`."""
