"""The DeepSeek-V2 world model's weights as the benchmark draws them from
the seed, one parameter at a time, so the check can draw them again layer
by layer without the program: parameter `name` comes from its own
generator, seeded from the run's seed and the name's CRC-32. Kernels are
N(0, 1/fan_in) (fan_in the last axis, also of the stacked experts), norm
scales 1 + N(0, 0.1^2), biases N(0, 0.02^2); the program holds them in its
dtype (bfloat16), and the check reads those rounded values in float32."""
from __future__ import annotations

import zlib

import torch


def param_seed(seed, name):
  return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % 2 ** 63


def draw(name, shape, seed, device):
  """Parameter `name` (float32) of the run with this seed."""
  g = torch.Generator(device=device)
  g.manual_seed(param_seed(seed, name))
  n = torch.randn(tuple(shape), generator=g, device=device)
  if name.endswith('.bias'):
    return 0.02 * n
  if len(shape) == 1:
    return 1.0 + 0.1 * n
  return n / float(shape[-1]) ** 0.5


def load_into(module, seed):
  """Every parameter of `module` drawn in place (in its dtype)."""
  with torch.no_grad():
    for name, p in module.named_parameters():
      p.copy_(draw(name, p.shape, seed, p.device))


def draw_all(shapes, seed, device, dtype):
  """{name: the parameter in `dtype`} for {name: shape}."""
  return {n: draw(n, s, seed, device).to(dtype) for n, s in shapes.items()}
