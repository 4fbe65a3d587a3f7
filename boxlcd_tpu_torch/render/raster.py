"""Binarized LCD rasterizer in plain torch, pixel-exact vs the reference's PIL.

The reference renders by PIL ImageDraw (reference: boxLCD/world_env.py:460-512):
polygons via `draw.polygon(trans * verts, fill=0)`, circles via
`draw.ellipse(bbox, fill=0)`, background 1, then a vertical flip. This module
reproduces that output bit for bit, batched over a leading worlds axis:

  * Polygons: Pillow truncates vertices to ints (C `(int)` cast in
    `_imaging.c:draw_polygon`) and scanline-fills with `polygon_generic`
    (libImaging/Draw.c): per-row edge intersections in float32, endpoint
    doubling, the corner-connection fix-up, sort + pair fill with
    floor(x+0.5)/round-half-toward-zero span ends, plus direct hlines for
    horizontal edges.
  * Circles: Pillow truncates the ellipse bbox to ints, after which the
    rasterized mask depends only on the integer bbox size (translation
    invariant). Masks for every reachable (iW, iH) are tabulated host-side
    with real PIL and gathered on the device.

This is the plain version of the CUDA kernel in render/cuda_raster.py (the
port of boxlcd_tpu/render/pallas_raster.py); `lcd_render` dispatches to that
module for W <= 32, which launches the kernel for tensors on the card.

Conventions matched to the reference:
  - world-to-pixel scale uses the world WIDTH for both axes
    (world_env.py:495-498: `pos / self.WIDTH * width`)
  - the image is y-flipped (world_env.py:506), so row 0 is the top
  - output is bool with background=True and bodies=False
    (world_env.py:471-477: background fill 1, shapes fill 0)

Row bitmasks (W <= 32, bit j = column j) are held in int64 and masked to 32
bits: torch has no shifts or compares on uint32.
"""
from __future__ import annotations

import numpy as np
import torch

from boxlcd_tpu_torch.engine import collision, physics
from boxlcd_tpu_torch.engine.spec import CIRCLE, POLY, WorldSpec

_INF = float('inf')


def _muladd(a, b, c):
  """a*b + c with the product rounded to float32 before the add (eager torch
  rounds every op; Pillow's C compiles to separate mulss/addss)."""
  return a * b + c


# -- host-side ellipse mask tables ---------------------------------------------

_TABLE_CACHE = {}


def _ellipse_mask_table(dmax: int) -> np.ndarray:
  """(dmax+1, dmax+1, dmax+2, dmax+2) bool: PIL ellipse masks per int bbox.

  Entry [iH, iW] is the pixel mask of `draw.ellipse([x0, y0, x0+iW, y0+iH],
  fill=...)` relative to (x0, y0); PIL is a host-side dependency."""
  from PIL import Image, ImageDraw
  D = dmax
  out = np.zeros((D + 1, D + 1, D + 2, D + 2), bool)
  pad = 3
  for ih in range(D + 1):
    for iw in range(D + 1):
      size = (iw + 2 * pad + 2, ih + 2 * pad + 2)
      im = Image.new('1', size)
      dr = ImageDraw.Draw(im)
      dr.rectangle([0, 0, size[0], size[1]], fill=1)
      dr.ellipse([pad, pad, pad + iw, pad + ih], fill=0, outline=None)
      arr = ~np.asarray(im).astype(np.float32).astype(bool)
      if (arr[:pad].any() or arr[pad + ih + 2:].any()
          or arr[:, :pad].any() or arr[:, pad + iw + 2:].any()):
        raise RuntimeError('PIL ellipse painted outside its bbox')
      out[ih, iw, :ih + 2, :iw + 2] = arr[pad:pad + ih + 2, pad:pad + iw + 2]
  return out


def _tables(spec: WorldSpec, width: int, height: int):
  """(bool mask table, uint32 row-bitmask table or None); cached per spec
  (the cache holds the spec, so its id is never reused)."""
  key = (id(spec), width, height)
  hit = _TABLE_CACHE.get(key)
  if hit is None or hit[0] is not spec:
    s = width / spec.width
    dmax = int(np.floor(2.0 * float(spec.radius.max()) * s)) + 1
    tbl = _ellipse_mask_table(dmax)
    bits = None
    if tbl.shape[-1] <= 32:
      weights = (1 << np.arange(tbl.shape[-1], dtype=np.uint64))
      bits = (tbl.astype(np.uint64) * weights).sum(-1).astype(np.uint32)
    hit = _TABLE_CACHE[key] = (spec, tbl, bits)
  return hit[1], hit[2]


# -- float32 helpers matching Pillow's C arithmetic ------------------------------

def _roundf(x):
  """C roundf: round half away from zero (float32)."""
  a = torch.abs(x)
  fl = torch.floor(a)
  r = fl + (a - fl >= 0.5).to(x.dtype)
  return torch.where(x < 0, -r, r)


def _x_start(f):
  """Span-start rounding from polygon_generic's hline call (disassembly)."""
  return torch.where(f >= 0, torch.floor(f + 0.5), -torch.floor(-f + 0.5))


def _x_end(f):
  """Span-end rounding: round half toward zero."""
  return torch.where(f >= 0, torch.ceil(f - 0.5), -torch.ceil(-f - 0.5))


# -- exact polygon scanline fill (PIL pixel frame) ----------------------------------

def _full_bits(width: int) -> int:
  return 0xFFFFFFFF if width >= 32 else (1 << width) - 1


def _unpack_bits(mask, width: int):
  """(..., H) int64 row bitmasks (bit j = column j) -> (..., H, W) bool."""
  cols = torch.arange(width, device=mask.device)
  return ((mask[..., None] >> cols) & 1).to(torch.bool)


def _bits_below(k, width: int):
  """int64 with bits [0, k) set; k in [0, W], W <= 32 (the shift is clamped
  to 31, as a 32-bit shift is undefined in C)."""
  kc = torch.clamp(k, max=31)
  return torch.where(k >= width, _full_bits(width), (1 << kc) - 1)


def _span_bits(a_f, b_f, valid, width: int):
  """(..., H) int64 with bits [a..b] set (clamped to [0, W)), where valid.

  a_f/b_f are the float span ends from _x_start/_x_end (integer-valued or
  +/-inf on padded slots, which `valid` excludes)."""
  a = torch.clamp(a_f, 0, width).to(torch.int64)
  b = torch.clamp(b_f, -1, width - 1).to(torch.int64) + 1      # half-open
  ok = valid & (a < b)
  lo = _bits_below(a, width)
  hi = _bits_below(b, width)
  return torch.where(ok, hi & ~lo, 0)


def _poly_fill(ivx, ivy, nv: int, height: int, width: int, rows=None):
  """(..., H) int64 row bitmasks (W <= 32) or (..., H, W) bool, PIL rules.

  ivx/ivy: (..., nv) int32 vertex coords (already truncated). rows: (H,)
  int32 PIL row index of each output slot (default arange; the batched
  render passes the reversed rows so that slot i holds image row i). Mirrors
  libImaging/Draw.c polygon_generic + the horizontal-edge hlines of
  ImagingDrawPolygon, as boxlcd_tpu's raster._poly_fill does.
  """
  dev = ivx.device
  if rows is None:
    rows = torch.arange(height, dtype=torch.int32, device=dev)
  ivx = [ivx[..., i, None] for i in range(nv)]                 # (..., 1) each
  ivy = [ivy[..., i, None] for i in range(nv)]
  S = 2 * nv + 2
  slots = torch.arange(S, device=dev)

  vymax = ivy[0]
  for i in range(1, nv):
    vymax = torch.maximum(vymax, ivy[i])
  gymax = torch.clamp(vymax, max=height)

  # edge table (non-horizontal edges keep polygon order)
  ex0, eymin, eymax, edx, ehoriz = [], [], [], [], []
  for i in range(nv):
    x0, y0 = ivx[i], ivy[i]
    x1, y1 = ivx[(i + 1) % nv], ivy[(i + 1) % nv]
    horiz = y0 == y1
    dx = torch.where(horiz, 0.0, (x1 - x0).float()
                     / torch.where(horiz, 1, y1 - y0).float())
    ex0.append(torch.where(y0 <= y1, x0, x1).float())
    eymin.append(torch.minimum(y0, y1))
    eymax.append(torch.maximum(y0, y1))
    edx.append(dx)
    ehoriz.append(horiz)

  def edge_x(k, y):
    return _muladd((y - eymin[k]).float(), edx[k], ex0[k])

  shape = torch.broadcast_shapes(ivx[0].shape, rows.shape)
  xx = torch.full((*shape, S), _INF, device=dev)
  j = torch.zeros(shape, dtype=torch.int64, device=dev)

  def write(xx, pos, cond, val):
    hit = cond[..., None] & (pos[..., None] == slots)
    return torch.where(hit, val[..., None], xx)

  for i in range(nv):
    inr = (~ehoriz[i]) & (rows >= eymin[i]) & (rows <= eymax[i])   # (..., H)
    cur_x = edge_x(i, rows)
    xx = write(xx, j, inr, cur_x)
    at_ymax = inr & (rows == eymax[i])
    at_ymin = inr & (rows == eymin[i])
    dbl = at_ymax & (rows < gymax)
    j1 = j + inr.long()
    xx = write(xx, j1, dbl, cur_x)
    # corner-connection fix-up (Draw.c: only at an endpoint row; at ymax only
    # on the clipped bottom row, where the doubling branch doesn't run)
    if i > 0:
      elig = (edx[i] != 0) & (at_ymin | (at_ymax & (rows >= gymax)))
      adj_y = rows + torch.where(at_ymax, -1, 1)
      adj = edge_x(i, adj_y)
      cur_r = _roundf(cur_x)
      found = torch.zeros_like(inr)
      adj_o = torch.zeros_like(cur_x)
      for k in range(i):
        ok = ((~ehoriz[k])
              & ((rows == eymin[k]) | (rows == eymax[k]))
              & (cur_r == _roundf(edge_x(k, rows)))
              & (adj_y >= eymin[k]) & (adj_y <= eymax[k]))
        adj_o = torch.where(ok & ~found, edge_x(k, adj_y), adj_o)
        found = found | ok
      hi = (cur_x > adj + 1) & (cur_x > adj_o + 1)
      lo = (cur_x < adj - 1) & (cur_x < adj_o - 1)
      fixv = torch.where(hi, _roundf(torch.maximum(adj, adj_o)) + 1,
                         _roundf(torch.minimum(adj, adj_o)) - 1)
      xx = write(xx, j, elig & found & (hi | lo), fixv)
    j = j1 + dbl.long()

  xs = torch.where(slots < j[..., None], xx, _INF)
  xs = torch.sort(xs, dim=-1).values
  a = _x_start(xs[..., 0::2])                                   # (..., H, S/2)
  b = _x_end(xs[..., 1::2])
  valid = j[..., None] >= 2 * torch.arange(S // 2, device=dev) + 2
  hx = []
  for i in range(nv):
    xmin = torch.minimum(ivx[i], ivx[(i + 1) % nv]).float()
    xmax = torch.maximum(ivx[i], ivx[(i + 1) % nv]).float()
    hx.append((xmin, xmax, ehoriz[i] & (rows == ivy[i])))
  if width <= 32:
    # bitmask span fill: one row = one int, O(pairs) int ops per row
    spans = _span_bits(a, b, valid, width)
    mask = spans[..., 0]
    for p in range(1, S // 2):
      mask = mask | spans[..., p]
    for xmin, xmax, hit in hx:
      mask = mask | _span_bits(xmin.expand(hit.shape), xmax.expand(hit.shape),
                               hit, width)
    return mask
  cols = torch.arange(width, dtype=torch.float32, device=dev)
  cov = (valid[..., None] & (cols >= a[..., None])
         & (cols <= b[..., None])).any(-2)
  # horizontal edges are hlined directly (ImagingDrawPolygon first loop)
  for xmin, xmax, hit in hx:
    cov = cov | (hit[..., None] & (cols >= xmin[..., None])
                 & (cols <= xmax[..., None]))
  return cov


# -- per-body coverage -----------------------------------------------------------

def _circle_bbox(cx, cy, r: float, s: float, dmax: int):
  ix0 = torch.trunc((cx - r) * s).to(torch.int64)
  iy0 = torch.trunc((cy - r) * s).to(torch.int64)
  iw = torch.clamp(torch.trunc((cx + r) * s).to(torch.int64) - ix0, 0, dmax)
  ih = torch.clamp(torch.trunc((cy + r) * s).to(torch.int64) - iy0, 0, dmax)
  return ix0, iy0, iw, ih


def _circle_cover(tbl, cx, cy, r: float, s: float, height: int, width: int):
  """(B, H, W) bool: PIL ellipse coverage of one circle per world (PIL pixel
  frame); tbl is the bool mask table as a tensor."""
  dmax = tbl.shape[0] - 1
  ix0, iy0, iw, ih = _circle_bbox(cx, cy, r, s, dmax)
  dev = cx.device
  di = torch.arange(height, device=dev) - iy0[:, None]             # (B, H)
  dj = torch.arange(width, device=dev) - ix0[:, None]              # (B, W)
  ok = (((di >= 0) & (di <= ih[:, None]))[:, :, None]
        & ((dj >= 0) & (dj <= iw[:, None]))[:, None, :])
  dic = torch.clamp(di, 0, dmax + 1)
  djc = torch.clamp(dj, 0, dmax + 1)
  return ok & tbl[ih[:, None, None], iw[:, None, None], dic[:, :, None],
                  djc[:, None, :]]


def _circle_fill(tblbits, cx, cy, r: float, s: float, height: int, width: int,
                 rows=None):
  """(B, H) int64 row bitmasks of PIL ellipse coverage (W <= 32 path).

  tblbits: the uint32 row-bitmask table as an int64 tensor. rows: optional
  (H,) PIL row index of each output slot (default arange)."""
  dmax = tblbits.shape[0] - 1
  ix0, iy0, iw, ih = _circle_bbox(cx, cy, r, s, dmax)
  if rows is None:
    rows = torch.arange(height, device=cx.device)
  di = rows - iy0[:, None]                                         # (B, H)
  ok = (di >= 0) & (di <= ih[:, None])
  rowbits = tblbits[ih[:, None], iw[:, None], torch.clamp(di, 0, dmax + 1)]
  # shift the mask (bit j = column ix0+j) into image columns
  ix0 = ix0[:, None]
  shifted = torch.where(
      ix0 >= 0,
      torch.where(ix0 < 32, rowbits << torch.clamp(ix0, 0, 31), 0),
      torch.where(-ix0 < 32, rowbits >> torch.clamp(-ix0, 0, 31), 0))
  return torch.where(ok, shifted & _full_bits(width), 0)


def _poly_verts_px_batch(spec, c, cosa, sina, s: float, b: int):
  """Truncated pixel-space draw vertices of body b in every world:
  c (B, N, 2), cosa/sina (B, N) -> ivx, ivy (B, nv) int32.

  b2Mul op order: w = (cos*vx - sin*vy) + origin, each product rounded."""
  nv = int(spec.nverts[b])
  dv = torch.as_tensor(spec.draw_verts[b, :nv], device=c.device)   # (nv, 2)
  lc0, lc1 = (float(x) for x in spec.local_center[b, 1])
  ca = cosa[:, b, None]
  sa = sina[:, b, None]
  ox = c[:, b, 0, None] - (ca * lc0 - sa * lc1)
  oy = c[:, b, 1, None] - (sa * lc0 + ca * lc1)
  wx = (ca * dv[:, 0] - sa * dv[:, 1]) + ox
  wy = (sa * dv[:, 0] + ca * dv[:, 1]) + oy
  return (torch.trunc(wx * s).to(torch.int32),
          torch.trunc(wy * s).to(torch.int32))


def _scale(spec, width: int) -> float:
  """World-to-pixel scale, a float32 value (world_env.py:495-498)."""
  return float(np.float32(width / spec.width))


def _body_fills(spec, is_circle, c, cosa, sina, width, height, bits,
                rows=None):
  """Per-body coverage of every world in the PIL (unflipped) frame, or in
  the row order `rows` gives: a list of (B, H) int64 row bitmasks
  (bits=True, W <= 32) or (B, H, W) bools."""
  tbl, tblbits = _tables(spec, width, height)
  dev = c.device
  tbl_t = torch.as_tensor(tblbits.astype(np.int64) if bits else tbl,
                          device=dev)
  s = _scale(spec, width)
  fills = []
  for b in range(spec.n):
    kind = int(spec.shape_static[b])
    circ = poly = None
    if kind != POLY:
      r = float(spec.radius[b])
      circ = (_circle_fill(tbl_t, c[:, b, 0], c[:, b, 1], r, s, height,
                           width, rows=rows) if bits
              else _circle_cover(tbl_t, c[:, b, 0], c[:, b, 1], r, s,
                                 height, width))
    if kind != CIRCLE:
      ivx, ivy = _poly_verts_px_batch(spec, c, cosa, sina, s, b)
      poly = _poly_fill(ivx, ivy, int(spec.nverts[b]), height, width,
                        rows=rows)
    if circ is None:
      fill = poly
    elif poly is None:
      fill = circ
    else:
      ic = is_circle[:, b]
      fill = torch.where(ic.view(-1, *([1] * (circ.dim() - 1))), circ, poly)
    fills.append(fill)
  return fills


def kernel_supported(spec: WorldSpec, width: int, height: int) -> bool:
  """The row-bitmask layout (one 32-bit word per row) holds the frame."""
  return width <= 32 and _tables(spec, width, height)[1] is not None


def lcd_rows_plain(spec: WorldSpec, is_circle, c, cosa, sina, width: int,
                   height: int):
  """(B, H) int32 inverted row bitmasks in image-row order (bit j = column
  j, 1 = background), the uint32 bit pattern held in int32: exactly what the
  CUDA kernel writes. cosa/sina: (B, N) float32 cos/sin of the angles."""
  if not kernel_supported(spec, width, height):
    raise ValueError(f'row bitmasks need W <= 32, got {width}')
  rows = torch.arange(height - 1, -1, -1, device=c.device)   # PIL flip
  mask = torch.zeros((c.shape[0], height), dtype=torch.int64, device=c.device)
  for f in _body_fills(spec, is_circle, c, cosa, sina, width, height, True,
                       rows=rows):
    mask = mask | f
  mask = mask ^ _full_bits(width)
  return torch.where(mask >= 2 ** 31, mask - 2 ** 32, mask).to(torch.int32)


def body_row_ranges(spec: WorldSpec, is_circle, c, cosa, sina, width: int,
                    height: int):
  """(ylo, yhi), each (B, N) int64: the PIL rows [ylo, yhi] of each body,
  clipped to the frame (empty where ylo > yhi), by the raster kernels' setup
  rules (csrc/lcd_common.cuh): a polygon's truncated vertices' y range, a
  circle's integer bbox rows. Outside them a body's fill is 0, so the
  kernels skip those rows; nothing on the main path calls this, the tests
  hold the plain fill to it."""
  tbl, _ = _tables(spec, width, height)
  dmax = tbl.shape[0] - 1
  s = _scale(spec, width)
  los, his = [], []
  for b in range(spec.n):
    kind = int(spec.shape_static[b])
    lo = hi = None
    if kind != POLY:
      _, iy0, _, ih = _circle_bbox(c[:, b, 0], c[:, b, 1],
                                   float(spec.radius[b]), s, dmax)
      lo, hi = iy0, iy0 + ih
    if kind != CIRCLE:
      _, ivy = _poly_verts_px_batch(spec, c, cosa, sina, s, b)
      plo, phi = ivy.min(-1).values.long(), ivy.max(-1).values.long()
      if lo is None:
        lo, hi = plo, phi
      else:
        ic = is_circle[:, b]
        lo, hi = torch.where(ic, lo, plo), torch.where(ic, hi, phi)
    los.append(torch.clamp(lo, min=0))
    his.append(torch.clamp(hi, max=height - 1))
  return torch.stack(los, 1), torch.stack(his, 1)


def unpack_rows(rows, width: int):
  """(B, H) int32 row bitmasks -> (B, H, W) bool."""
  return _unpack_bits(rows.to(torch.int64) & 0xFFFFFFFF, width)


def exact_cover(spec: WorldSpec, is_circle, c, angle, width: int, height: int):
  """(B, H, W, N) bool per-body coverage in the FINAL (y-flipped) frame."""
  covs = _body_fills(spec, is_circle, c, torch.cos(angle), torch.sin(angle),
                     width, height, bits=False)
  return torch.stack(covs, dim=-1).flip(1)  # PIL FLIP_TOP_BOTTOM (world_env.py:506)


def lcd_render_plain(spec: WorldSpec, is_circle, c, cosa, sina, width: int,
                     height: int):
  """(B, H, W) bool frames from the plain torch path, any width."""
  if kernel_supported(spec, width, height):
    return unpack_rows(lcd_rows_plain(spec, is_circle, c, cosa, sina, width,
                                      height), width)
  covs = _body_fills(spec, is_circle, c, cosa, sina, width, height,
                     bits=False)
  return ~torch.stack(covs, dim=-1).any(-1).flip(1)


def lcd_render(spec: WorldSpec, is_circle, c, angle, width: int, height: int):
  """Binarized frames, (B, H, W) bool, background True, for a batch of
  worlds: is_circle (B, N), c (B, N, 2), angle (B, N).

  Bitwise-equal to the reference `WorldEnv.lcd_render(mode='1')` given the
  same body poses (reference: boxLCD/world_env.py:460-512). For W <= 32 the
  frame goes through render/cuda_raster.py, which launches the CUDA kernel
  for tensors on the card and uses the plain path for tensors on the CPU;
  wider frames take the plain path, as boxlcd_tpu's do on the TPU."""
  if kernel_supported(spec, width, height):
    from boxlcd_tpu_torch.render import cuda_raster
    return cuda_raster.make_batched_render(spec, width, height)(
        is_circle, c, angle)
  return lcd_render_plain(spec, is_circle, c, torch.cos(angle),
                          torch.sin(angle), width, height)


# -- approximate RGB render (human viz only) -------------------------------------

def coverage(spec: WorldSpec, is_circle, c, angle, width: int, height: int):
  """(B, H, W, N) bool pixel-center coverage (approximate; viz only)."""
  K = physics.consts(spec, c.device)
  geom = collision.make_geom(K, is_circle, c, torch.cos(angle),
                             torch.sin(angle))
  sc = width / spec.width
  dev = c.device
  wx = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / sc
  wy = (height - torch.arange(height, dtype=torch.float32, device=dev)
        - 0.5) / sc
  gy, gx = torch.meshgrid(wy, wx, indexing='ij')
  pix = torch.stack([gx, gy], -1).reshape(-1, 2)                   # (HW, 2)
  d2 = ((pix[None, :, None, :] - geom.c[:, None, :, :]) ** 2).sum(-1)
  cov_circle = d2 <= (geom.radius ** 2)                            # (B, HW, N)
  rel = pix[None, :, None, None, :] - geom.wverts[:, None]         # (B, HW, N, V, 2)
  side = (rel * geom.wnormals[:, None]).sum(-1)
  side = torch.where(geom.vmask, side, -_INF)
  cov_poly = (side <= 0.0).all(-1)
  cov = torch.where(geom.is_circle[:, None, :], cov_circle, cov_poly)
  return cov.reshape(c.shape[0], height, width, -1)


def rgb_render(spec: WorldSpec, is_circle, c, angle, width: int, height: int,
               robot_mask=None):
  """Simple RGB frames (B, H, W, 3) uint8 using the reference body palette.

  Robots render reddish (0.9, 0.4, 0.4), objects bluish (0.5, 0.4, 0.9)
  (reference: boxLCD/world_env.py:201,303), on white background, matching
  the color-inversion at world_env.py:510-511. Painter's order: later bodies
  draw over earlier ones, like PIL's sequential draws.
  """
  cov = exact_cover(spec, is_circle, c, angle, width, height)    # (B, H, W, N)
  dev = c.device
  if robot_mask is None:
    robot_mask = torch.as_tensor(spec.role != 2, device=dev)
  robot_col = torch.tensor([0.9, 0.4, 0.4], device=dev)
  obj_col = torch.tensor([0.5, 0.4, 0.9], device=dev)
  body_col = torch.where(robot_mask[:, None], robot_col, obj_col)  # (N, 3)
  any_cov = cov.any(-1, keepdim=True)
  # last covering body wins (PIL painter's order over dynbodies)
  n = cov.shape[-1]
  last = n - 1 - torch.argmax(cov.flip(-1).to(torch.uint8), dim=-1)
  img = torch.where(any_cov, body_col[last], torch.ones(3, device=dev))
  return (img * 255).to(torch.uint8)
