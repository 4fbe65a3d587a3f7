"""The port's plain torch raster: bit-exact vs Pillow and vs boxlcd_tpu's.

The plain version in boxlcd_tpu_torch/render/raster.py is what the CUDA
kernel is held against on the card, so it must reproduce PIL bit for bit:
fill kernels against Pillow on the fuzz cases of tests/test_raster.py,
whole frames against JAX `raster._lcd_render_single` (fed the same JAX
cos/sin, since trig is not bit-specified across libms), and scenes against
a PIL oracle with the port's own trig, W > 32 included. All comparisons are
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu.render import raster as jraster
from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import cuda_raster, raster

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


def pil_polygon(pts, W, H):
  im = Image.new('1', (W, H))
  d = ImageDraw.Draw(im)
  d.rectangle([0, 0, W, H], fill=1)
  d.polygon([tuple(map(float, p)) for p in pts], fill=0, outline=None)
  return ~np.asarray(im).astype(np.float32).astype(bool)


def pil_ellipse(bbox, W, H):
  im = Image.new('1', (W, H))
  d = ImageDraw.Draw(im)
  d.rectangle([0, 0, W, H], fill=1)
  d.ellipse([float(v) for v in bbox], fill=0, outline=None)
  return ~np.asarray(im).astype(np.float32).astype(bool)


def _convex_hull(pts):
  pts = sorted({tuple(p) for p in pts})
  if len(pts) < 3:
    return None

  def cross(o, a, b):
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])
  lower, upper = [], []
  for p in pts:
    while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
      lower.pop()
    lower.append(p)
  for p in reversed(pts):
    while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
      upper.pop()
    upper.append(p)
  h = lower[:-1] + upper[:-1]
  return h if len(h) >= 3 else None


def _cover(ivx, ivy, nv, H, W):
  """(B, H, W) bool coverage through the port's _poly_fill (row bitmasks
  for W <= 32, bool coverage above)."""
  out = raster._poly_fill(torch.as_tensor(ivx), torch.as_tensor(ivy), nv, H, W)
  return (raster._unpack_bits(out, W) if W <= 32 else out).numpy()


@pytest.mark.parametrize('W', [16, 40])
@pytest.mark.parametrize('nv', [3, 4, 5, 6])
def test_polygon_fill_matches_pil(nv, W):
  H = 16
  rng = np.random.default_rng(nv)
  cases = []
  while len(cases) < 150:
    pts = rng.integers(-3, 19, size=(nv + 2, 2))
    h = _convex_hull([tuple(map(int, p)) for p in pts])
    if h is not None and len(h) == nv:
      cases.append(h)
  arr = np.array(cases, dtype=np.int32)              # (B, nv, 2)
  ours = _cover(arr[..., 0], arr[..., 1], nv, H, W)
  for i, pts in enumerate(cases):
    assert np.array_equal(ours[i], pil_polygon(pts, W, H)), \
        f'polygon mismatch: {pts}'


def test_rotated_rect_fill_matches_pil():
  W = H = 16
  rng = np.random.default_rng(0)
  cases = []
  for _ in range(200):
    cx, cy = rng.uniform(0, 16, 2)
    w, h = rng.uniform(0.4, 6, 2)
    th = rng.uniform(0, 2 * np.pi)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    base = np.array([[-w, -h], [w, -h], [w, h], [-w, h]])
    cases.append(np.trunc(base @ R.T + [cx, cy]).astype(np.int32))
  arr = np.array(cases)
  ours = _cover(arr[..., 0], arr[..., 1], 4, H, W)
  for i, pts in enumerate(cases):
    assert np.array_equal(ours[i], pil_polygon(pts, W, H)), \
        f'rect mismatch: {pts.tolist()}'


def test_circle_fill_matches_pil():
  W, H = 24, 16
  rng = np.random.default_rng(1)
  tbl = raster._ellipse_mask_table(14)
  weights = 1 << np.arange(tbl.shape[-1], dtype=np.int64)
  tblbits = torch.as_tensor((tbl.astype(np.int64) * weights).sum(-1))
  cx = torch.as_tensor(rng.uniform(-3, 27, 300).astype(np.float32))
  cy = torch.as_tensor(rng.uniform(-3, 19, 300).astype(np.float32))
  r = torch.as_tensor(rng.uniform(0.3, 6.0, 300).astype(np.float32))
  cover = raster._circle_cover(torch.as_tensor(tbl), cx, cy, r, 1.0, H, W)
  rows = raster._unpack_bits(
      raster._circle_fill(tblbits, cx, cy, r, 1.0, H, W), W)
  for i in range(len(cx)):
    want = pil_ellipse([cx[i] - r[i], cy[i] - r[i], cx[i] + r[i],
                        cy[i] + r[i]], W, H)
    assert np.array_equal(cover[i].numpy(), want), f'circle {i}'
    assert np.array_equal(rows[i].numpy(), want), f'circle rows {i}'


def _jax_poses(env, n_worlds, seed):
  """JAX-reset poses, jittered so bodies turn freely and some cross the
  frame's edges."""
  keys = jax.random.split(jax.random.PRNGKey(seed), n_worlds)
  st = jax.jit(jax.vmap(lambda k: JEnv.reset(env, k)))(keys)
  rng = np.random.default_rng(seed)
  c = np.asarray(st.c) + rng.normal(0, 0.6, st.c.shape).astype(np.float32)
  a = np.asarray(st.a) + rng.normal(0, 1.0, st.a.shape).astype(np.float32)
  return np.asarray(st.is_circle), c, a


@pytest.mark.parametrize('env_name,width,height', [
    ('Urchin', 32, 16), ('LuxoCube', 24, 16), ('Object3', 16, 16),
    ('Dropbox', 16, 16),
])
def test_lcd_render_matches_jax(env_name, width, height):
  env = boxlcd_tpu.env_map[env_name]({})
  spec = boxlcd_tpu_torch.env_map[env_name](device='cpu').spec
  ic, c, a = _jax_poses(env, 48, seed=2)
  want = np.asarray(jax.jit(jax.vmap(
      lambda i, cc, aa: jraster._lcd_render_single(
          env.spec, i, cc, aa, width, height)))(ic, c, a))
  cosa = np.asarray(jnp.cos(jnp.asarray(a)))
  sina = np.asarray(jnp.sin(jnp.asarray(a)))
  got = raster.lcd_render_plain(
      spec, torch.as_tensor(ic), torch.as_tensor(c), torch.as_tensor(cosa),
      torch.as_tensor(sina), width, height).numpy()
  assert got.shape == want.shape and got.dtype == want.dtype
  mismatched = int((got != want).any(axis=(1, 2)).sum())
  assert mismatched == 0, f'{mismatched}/48 frames differ from boxlcd_tpu'
  assert not want.all(), 'no body drawn'


def _pil_scene_render(spec, is_circle, c, cossin, width, height):
  """Oracle: PIL draws with the same float32 pixel inputs the raster uses
  (the pattern of tests/test_raster.py)."""
  s = np.float32(width / spec.width)
  im = Image.new('1', (width, height))
  d = ImageDraw.Draw(im)
  d.rectangle([0, 0, width, height], fill=1)
  for b in range(spec.n):
    if bool(is_circle[b]):
      r = np.float32(spec.radius[b])
      bbox = [np.float32((c[b, 0] - r) * s), np.float32((c[b, 1] - r) * s),
              np.float32((c[b, 0] + r) * s), np.float32((c[b, 1] + r) * s)]
      d.ellipse([float(v) for v in bbox], fill=0, outline=None)
    else:
      nv = int(spec.nverts[b])
      dv = spec.draw_verts[b, :nv].astype(np.float32)
      lc = spec.local_center[b, 1].astype(np.float32)
      ca = np.float32(cossin[b, 0])
      sa = np.float32(cossin[b, 1])
      cx, cy = np.float32(c[b, 0]), np.float32(c[b, 1])
      ox = cx - (np.float32(ca * lc[0]) - np.float32(sa * lc[1]))
      oy = cy - (np.float32(sa * lc[0]) + np.float32(ca * lc[1]))
      pts = []
      for v in dv:
        wx = (np.float32(ca * v[0]) - np.float32(sa * v[1])) + ox
        wy = (np.float32(sa * v[0]) + np.float32(ca * v[1])) + oy
        pts.append((float(np.float32(wx * s)), float(np.float32(wy * s))))
      d.polygon(pts, fill=0, outline=None)
  arr = np.asarray(im.transpose(method=Image.FLIP_TOP_BOTTOM))
  return arr.astype(np.float32).astype(bool)


# Crab at 64x32 (W > 32, the bool-coverage path) is held to PIL here rather
# than to JAX: XLA takes ~25 s to compile its 17-body render on the CPU
@pytest.mark.parametrize('env_name,width,height', [
    ('Dropbox', 16, 16), ('Bounce2', 16, 16), ('Object3', 24, 16),
    ('Urchin', 16, 16), ('Luxo', 16, 16), ('Crab', 40, 16), ('Crab', 64, 32),
])
def test_scene_parity_vs_pil(env_name, width, height):
  env = boxlcd_tpu_torch.env_map[env_name](device='cpu')
  gen = torch.Generator().manual_seed(0)
  st = Env.reset(env, gen, 48)
  ours = raster.lcd_render(env.spec, st.is_circle, st.c, st.a, width,
                           height).numpy()
  cossin = torch.stack([torch.cos(st.a), torch.sin(st.a)], -1).numpy()
  ic, cs = st.is_circle.numpy(), st.c.numpy()
  mismatched = sum(
      not np.array_equal(ours[w], _pil_scene_render(
          env.spec, ic[w], cs[w], cossin[w], width, height))
      for w in range(48))
  assert mismatched == 0, f'{mismatched}/48 frames differ from PIL'


def test_batched_render_on_cpu_takes_plain_path():
  env = boxlcd_tpu_torch.env_map['Object3'](device='cpu')
  gen = torch.Generator().manual_seed(1)
  st = Env.reset(env, gen, 16)
  render = cuda_raster.make_batched_render(env.spec, env.lcd_w, env.lcd_h)
  before = trace.counter('lcd_raster.launches')
  got = render(st.is_circle, st.c, st.a)
  assert trace.counter('lcd_raster.launches') == before
  want = raster.lcd_render_plain(env.spec, st.is_circle, st.c,
                                 torch.cos(st.a), torch.sin(st.a),
                                 env.lcd_w, env.lcd_h)
  assert got.dtype == torch.bool and torch.equal(got, want)
  with pytest.raises(ValueError):
    render.kernel_rows(st.is_circle, st.c, torch.cos(st.a), torch.sin(st.a))


@pytest.mark.parametrize('env_name,width,height', [
    ('Urchin', 32, 16), ('LuxoCube', 24, 16), ('Object3', 16, 16),
    ('Bounce2', 16, 16), ('CrabCube', 32, 32),
])
def test_body_fill_is_blank_outside_its_row_range(env_name, width, height):
  """The raster kernels compute a body's rows only inside the range
  raster.body_row_ranges gives: each body rendered alone through
  lcd_rows_plain must be blank outside it. Poses cross every edge of the
  frame, the bottom PIL row's gymax clip included."""
  env = boxlcd_tpu_torch.env_map[env_name](device='cpu')
  spec = env.spec
  B = 96
  gen = torch.Generator().manual_seed(3)
  st = Env.reset(env, gen, B)
  s = raster._scale(spec, width)
  u = torch.rand((B, spec.n, 3), generator=gen)
  # uniform over 1.5x the frame's extent in world units
  c = torch.stack([(u[..., 0] * 1.5 - 0.25) * (width / s),
                   (u[..., 1] * 1.5 - 0.25) * (height / s)], -1)
  c[:B // 4] = st.c[:B // 4]                   # a quarter at reset poses
  a = (u[..., 2] * 2 - 1) * np.pi
  cosa, sina = torch.cos(a), torch.sin(a)
  ylo, yhi = raster.body_row_ranges(spec, st.is_circle, c, cosa, sina,
                                    width, height)
  full = (1 << width) - 1
  pil_y = torch.arange(height - 1, -1, -1)     # image row r is PIL row H-1-r
  dmax = raster._tables(spec, width, height)[0].shape[0] - 1
  past_bottom = empty = 0
  for b in range(spec.n):
    alone = torch.full_like(c, -1000.0)        # every other body off-frame
    alone[:, b] = c[:, b]
    rows = raster.lcd_rows_plain(spec, st.is_circle, alone, cosa, sina,
                                 width, height)
    fill = (rows.long() & 0xFFFFFFFF) ^ full   # (B, H) bits the body draws
    inside = ((pil_y >= ylo[:, b, None]) & (pil_y <= yhi[:, b, None]))
    assert int((fill[~inside] != 0).sum()) == 0, b
    empty += int((ylo[:, b] > yhi[:, b]).sum())
    # bodies that run past PIL row H-1 (for polygons, the gymax clip) and
    # draw on it
    _, iy0, _, ih = raster._circle_bbox(c[:, b, 0], c[:, b, 1],
                                        float(spec.radius[b]), s, dmax)
    _, ivy = raster._poly_verts_px_batch(spec, c, cosa, sina, s, b)
    circ = (st.is_circle[:, b] if int(spec.shape_static[b]) == 2
            else torch.full((B,), int(spec.shape_static[b]) == 0))
    top = torch.where(circ, iy0 + ih, ivy.max(-1).values.long())
    past_bottom += int(((top >= height) & (fill[:, 0] != 0)).sum())
  assert past_bottom > 0 and empty > 0
