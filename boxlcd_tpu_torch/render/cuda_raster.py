"""Batched exact LCD raster: the CUDA kernel csrc/lcd_raster.cu and its wrapper.

The port of boxlcd_tpu/render/pallas_raster.py (`make_batched_render`, whose
pl.pallas_call runs the polygon scanline fill per world). The CUDA kernel
computes the whole frame in one launch: the b2Mul vertex transform and
truncation, Pillow's scanline fill of every polygon, the tabulated PIL
ellipse rows of every circle, the RANDOM-shape select, the inversion and the
vertical flip. It writes (B, H) int32 row bitmasks (the uint32 bit pattern,
bit j = column j, 1 = background) in image-row order; the unpack to (B, H, W)
bool is plain torch.

cos/sin of the angles are computed outside the kernel with torch.cos /
torch.sin and fed to kernel and plain version alike, so the two are
bit-comparable on the card.

For tensors on the CPU the wrapper takes the plain version
(raster.lcd_rows_plain); for tensors on the card it launches the kernel or
raises. The tracer's counter `lcd_raster.launches` counts the kernel's
launches.

`launch_geometry` sizes a launch of either raster kernel (this one and
csrc/traj_raster.cu, which share csrc/lcd_common.cuh's frame core): a tile of
G lanes per frame, frames a one-warp block, blocks, the dynamic shared memory
of the frames' body slots, and the compile-time vertex bound NV; the C
launchers check it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from boxlcd_tpu_torch import _build, trace
from boxlcd_tpu_torch.engine.spec import WorldSpec
from boxlcd_tpu_torch.render import raster
from boxlcd_tpu_torch.utils import MAX_SHARED_BYTES

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 10 + [ctypes.c_long] + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [_P, _P]

# csrc/lcd_common.cuh's block of THREADS lanes and body slot: a header of
# HEAD_WORDS words, then EDGE_ARRAYS arrays of NV words (the launchers check
# the sizes this gives)
THREADS, HEAD_WORDS, EDGE_ARRAYS = 32, 4, 6
VERTEX_BOUNDS = (4, 8)             # the NV the kernels are built for


class Geometry(NamedTuple):
  """One launch of a raster kernel: `lanes` a frame, `frames` a block,
  `blocks` blocks, `shared` bytes of dynamic shared memory a block, `nv` the
  vertex bound it is instantiated for."""
  lanes: int
  frames: int
  blocks: int
  shared: int
  nv: int

  @property
  def threads(self):
    return self.lanes * self.frames


def tile_lanes(height: int, nv: int) -> int:
  """Lanes a frame: H rounded up to a power of two, at most a warp and at
  least a body's group of nv lanes (the setup's)."""
  return max(nv, min(32, 1 << max(0, height - 1).bit_length()))


def vertex_bound(spec: WorldSpec) -> int:
  """The kernel's NV for `spec`: the least of VERTEX_BOUNDS that holds its
  largest vertex count."""
  most = int(np.max(spec.nverts))
  for nv in VERTEX_BOUNDS:
    if most <= nv:
      return nv
  raise ValueError(f'{most} polygon vertices: the raster kernels take at '
                   f'most {VERTEX_BOUNDS[-1]}')


def frame_words(n: int, height: int, nv: int) -> int:
  """4-byte words of one frame's shared memory: its row words padded to 4,
  then n body slots."""
  return -(-height // 4) * 4 + n * (HEAD_WORDS + EDGE_ARRAYS * nv)


def launch_geometry(spec: WorldSpec, frames: int, height: int) -> Geometry:
  """The launch of a raster kernel for `frames` frames of `spec` at `height`
  rows: blocks of one warp, THREADS // G frames each."""
  nv = vertex_bound(spec)
  G = tile_lanes(height, nv)
  words = frame_words(spec.n, height, nv)
  per = THREADS // G
  if per * words * 4 > MAX_SHARED_BYTES:
    raise ValueError(f'{per} frames of {words} words outgrow a block')
  return Geometry(G, per, -(-frames // per), per * words * 4, nv)


def _lib():
  lib = _build.load('lcd_raster')
  fn = lib.lcd_raster_launch
  if fn.argtypes is None:
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
  return fn


class RasterConsts:
  """The per-spec constant tables both raster kernels read (shape flags,
  vertex counts, radii, draw vertices, local-center y, the PIL ellipse row
  table), with the table's largest diameter `dmax` and the pixel `scale`,
  for one spec and frame size (W <= 32)."""

  def __init__(self, spec: WorldSpec, width: int, height: int):
    if not raster.kernel_supported(spec, width, height):
      raise ValueError(f'the row-bitmask raster needs W <= 32, got {width}')
    vertex_bound(spec)
    _, tblbits = raster._tables(spec, width, height)
    self.dmax = tblbits.shape[0] - 1
    self.scale = raster._scale(spec, width)
    self.verts = spec.draw_verts.shape[1]
    self._host = {
        'shape_static': np.ascontiguousarray(spec.shape_static, np.int32),
        'nverts': np.ascontiguousarray(spec.nverts, np.int32),
        'radius': np.ascontiguousarray(spec.radius, np.float32),
        'draw_verts': np.ascontiguousarray(spec.draw_verts, np.float32),
        'lc': np.ascontiguousarray(spec.local_center[:, 1], np.float32),
        'tbl': np.ascontiguousarray(tblbits.view(np.int32)),
    }
    self._dev = {}

  def tables(self, device):
    """The tables as tensors on `device`, in the kernels' argument order."""
    key = str(device)
    if key not in self._dev:
      self._dev[key] = {k: torch.as_tensor(v, device=device)
                        for k, v in self._host.items()}
    return self._dev[key]

  def pointers(self, device):
    return [t.data_ptr() for t in self.tables(device).values()]


class BatchedRender:
  """render(is_circle (B, N), c (B, N, 2), angle (B, N)) -> (B, H, W) bool
  frames for one spec and frame size (W <= 32)."""

  def __init__(self, spec: WorldSpec, width: int, height: int):
    self.consts = RasterConsts(spec, width, height)
    self.spec, self.width, self.height = spec, width, height

  def __call__(self, is_circle, c, angle):
    rows = self.rows(is_circle, c, torch.cos(angle), torch.sin(angle))
    return raster.unpack_rows(rows, self.width)

  def rows(self, is_circle, c, cosa, sina):
    """(B, H) int32 inverted row bitmasks in image-row order."""
    if c.is_cuda:
      return self.kernel_rows(is_circle, c, cosa, sina)
    return self.plain_rows(is_circle, c, cosa, sina)

  def plain_rows(self, is_circle, c, cosa, sina):
    return raster.lcd_rows_plain(self.spec, is_circle, c, cosa, sina,
                                 self.width, self.height)

  def kernel_rows(self, is_circle, c, cosa, sina):
    """Launch csrc/lcd_raster.cu on the current stream, at
    launch_geometry(spec, B, H)."""
    spec = self.spec
    B, N = is_circle.shape if is_circle.dim() == 2 else (-1, -1)
    if N != spec.n:
      raise ValueError(f'is_circle must be (B, {spec.n}), got '
                       f'{tuple(is_circle.shape)}')
    for name, t, dtype, shape in (('is_circle', is_circle, torch.bool, (B, N)),
                                  ('c', c, torch.float32, (B, N, 2)),
                                  ('cosa', cosa, torch.float32, (B, N)),
                                  ('sina', sina, torch.float32, (B, N))):
      if not t.is_cuda or t.device != c.device:
        raise ValueError(f'{name} must lie on the same CUDA device as c')
      if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f'{name} must be {dtype} {shape}, got {t.dtype} '
                         f'{tuple(t.shape)}')
      if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    K = self.consts
    out = torch.empty((B, self.height), dtype=torch.int32, device=c.device)
    if B == 0:
      return out
    geo = launch_geometry(spec, B, self.height)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):   # launch on the tensors' card
      err = _lib()(is_circle.data_ptr(), c.data_ptr(), cosa.data_ptr(),
                   sina.data_ptr(), *K.pointers(c.device), B, N, K.verts,
                   self.height, self.width, K.dmax, K.scale, geo.nv,
                   geo.lanes, geo.threads, geo.shared, out.data_ptr(), stream)
    if err != 0:
      raise RuntimeError(f'lcd_raster launch failed: cudaError {err}')
    trace.count('lcd_raster.launches')
    return out


_RENDERS = {}


def make_batched_render(spec: WorldSpec, width: int, height: int
                        ) -> BatchedRender:
  """Batched exact LCD render for `spec` at W x H (W <= 32); cached (the
  cache holds the spec, so its id is never reused)."""
  key = (id(spec), width, height)
  hit = _RENDERS.get(key)
  if hit is None or hit.spec is not spec:
    hit = _RENDERS[key] = BatchedRender(spec, width, height)
  return hit
