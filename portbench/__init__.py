"""The benchmark of boxlcd_tpu_torch, the PyTorch and CUDA port: one cell of
BENCHMARK.json run once by `python3 -m portbench.run`. Nothing here imports
JAX or the JAX package; the plain reference (portbench/reference) imports
nothing of the port."""
