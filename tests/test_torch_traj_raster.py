"""The port's trajectory raster (render/traj_raster.py) vs boxlcd_tpu's.

The same numpy-made poses of a (T, B) rollout, spread across and slightly
beyond the world box as tests/test_traj_raster.py makes them, go through JAX
`traj_raster.make_traj_render(..., interpret=True)` (the Pallas kernel in
interpret mode) and the port's `TrajRender.rows` on the CPU (its plain
version). Both are PIL-exact rasters fed the same poses, so the frames must
agree bit for bit: no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.engine.spec import RANDOM
from boxlcd_tpu.render import traj_raster as jtraj
from boxlcd_tpu_torch.render import raster, traj_raster

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

T, B = 3, 1024


def _poses(spec, seed=0):
  """c (T, B, n, 2), a (T, B, n), is_circle (B, n) as in test_traj_raster."""
  rng = np.random.RandomState(seed)
  n = spec.n
  c = np.stack([rng.uniform(-1, spec.width + 1, (T, B, n)),
                rng.uniform(-1, spec.height + 1, (T, B, n))],
               -1).astype(np.float32)
  a = rng.uniform(-np.pi, np.pi, (T, B, n)).astype(np.float32)
  shape = np.asarray(spec.shape_static)[None]
  ic = np.where(shape == RANDOM, rng.rand(B, n) < 0.5, shape == 0)
  return c, a, ic


def _stream(c, a):
  """The megakernel's pose stream (T, n, 3, B) from c and a."""
  return torch.as_tensor(np.concatenate(
      [np.moveaxis(c, 1, -1), np.moveaxis(a, 1, -1)[:, :, None]], 2))


@pytest.mark.parametrize('env_name', ['Urchin', 'Object3'])
def test_traj_raster_matches_jax(env_name):
  jenv = boxlcd_tpu.env_map[env_name]()
  env = boxlcd_tpu_torch.env_map[env_name](device='cpu')
  W, H = env.lcd_w, env.lcd_h
  c, a, ic = _poses(env.spec)
  n = env.spec.n
  tiles = np.zeros((T, n, 6, B // 128, 128), np.float32)
  for k, x in enumerate((c[..., 0], c[..., 1], a)):
    tiles[:, :, k] = np.moveaxis(x, 1, -1).reshape(T, n, B // 128, 128)
  jrows = jtraj.make_traj_render(jenv.spec, W, H, T, interpret=True)(
      jnp.asarray(tiles), jnp.asarray(ic))
  want = np.asarray(jtraj.rows_to_lcd(jrows, W))            # (T, B, H, W)

  render = traj_raster.make_traj_render(env.spec, W, H)
  rows = render.rows(_stream(c, a), torch.as_tensor(ic))
  assert rows.dtype == torch.int32 and rows.shape == (T, B, H)
  got = raster.unpack_rows(rows, W).numpy()
  assert got.shape == want.shape
  neq = int((got != want).sum())
  assert neq == 0, f'{env_name}: {neq}/{want.size} pixels differ'
  assert not got.all() and got.any()


def test_rows_are_the_per_frame_rows():
  """Frame (t, w) of the trajectory is the per-frame raster of its poses."""
  env = boxlcd_tpu_torch.env_map['LuxoCube'](device='cpu')
  spec = env.spec
  c, a, ic = _poses(spec, seed=1)
  rows = traj_raster.make_traj_render(spec, env.lcd_w, env.lcd_h).rows(
      _stream(c[:, :64], a[:, :64]), torch.as_tensor(ic[:64]))
  for t in range(T):
    at = torch.as_tensor(a[t, :64])
    want = raster.lcd_rows_plain(spec, torch.as_tensor(ic[:64]),
                                 torch.as_tensor(c[t, :64]), torch.cos(at),
                                 torch.sin(at), env.lcd_w, env.lcd_h)
    assert torch.equal(rows[t], want)


def test_supports_agrees_with_jax():
  for name in boxlcd_tpu.env_map:
    spec = boxlcd_tpu_torch.env_map[name](device='cpu').spec
    assert traj_raster.supports(spec) == jtraj.supports(
        boxlcd_tpu.env_map[name]().spec), name
