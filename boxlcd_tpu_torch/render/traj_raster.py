"""Exact LCD frames for a whole rollout: csrc/traj_raster.cu and its wrapper.

The port of boxlcd_tpu/render/traj_raster.py (`make_traj_render`, whose
pl.pallas_call renders every (step, world) frame of a megakernel rollout in
one launch). The kernel reads the pose stream in the layout the rollout
megakernel writes it (engine/mega.py: (T, N, 3, B), worlds minor; x, y,
angle) and the per-world shape flags is_circle (B, N) once per world, and
writes (T, B, H) int32 row bitmasks (the uint32 bit pattern, bit j = column
j, 1 = background) in image-row order: the layout csrc/lcd_raster.cu writes,
so raster.unpack_rows serves both.

cos/sin of the angles are computed outside the kernel with torch.cos /
torch.sin, as boxlcd_tpu computes them with XLA around its kernel, and fed to
kernel and plain version alike, so the two are bit-comparable on the card.

For tensors on the CPU the wrapper takes the plain version (the T * B frames
flattened through raster.lcd_rows_plain); for tensors on the card it launches
the kernel or raises. The tracer's counter `traj_raster.launches` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from boxlcd_tpu_torch import _build, trace
from boxlcd_tpu_torch.engine.spec import CIRCLE, POLY, RANDOM, WorldSpec
from boxlcd_tpu_torch.render import cuda_raster, raster

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 10 + [ctypes.c_long] * 2 + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [_P, _P]


def _lib():
  lib = _build.load('traj_raster')
  fn = lib.traj_raster_launch
  if fn.argtypes is None:
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
  return fn


def supports(spec: WorldSpec) -> bool:
  """Every shape flag, per-episode RANDOM included (boxlcd_tpu's rule)."""
  return all(int(s) in (CIRCLE, POLY, RANDOM) for s in spec.shape_static)


class TrajRender:
  """rows(poses (T, N, 3, B), is_circle (B, N)) -> (T, B, H) int32 inverted
  row bitmasks, for one spec and frame size (W <= 32)."""

  def __init__(self, spec: WorldSpec, width: int, height: int):
    if not supports(spec):
      raise ValueError('traj raster: unsupported shape flags')
    self.consts = cuda_raster.RasterConsts(spec, width, height)
    self.spec, self.width, self.height = spec, width, height

  def rows(self, poses, is_circle):
    ang = poses[:, :, 2]
    cosa, sina = torch.cos(ang), torch.sin(ang)                 # (T, N, B)
    if poses.is_cuda:
      return self.kernel_rows(poses, cosa, sina, is_circle)
    return self.plain_rows(poses, cosa, sina, is_circle)

  def plain_rows(self, poses, cosa, sina, is_circle):
    """The T * B frames flattened through raster.lcd_rows_plain."""
    T, N, _, B = poses.shape
    c = poses[:, :, :2].permute(0, 3, 1, 2).reshape(T * B, N, 2)
    flat = lambda x: x.permute(0, 2, 1).reshape(T * B, N)
    ic = is_circle[None].expand(T, B, N).reshape(T * B, N)
    return raster.lcd_rows_plain(self.spec, ic, c, flat(cosa), flat(sina),
                                 self.width, self.height).view(T, B, -1)

  def kernel_rows(self, poses, cosa, sina, is_circle):
    """Launch csrc/traj_raster.cu on the current stream, at
    cuda_raster.launch_geometry(spec, T * B, H)."""
    spec = self.spec
    if poses.dim() != 4 or poses.shape[1:3] != (spec.n, 3):
      raise ValueError(f'poses must be (T, {spec.n}, 3, B), got '
                       f'{tuple(poses.shape)}')
    T, N, _, B = poses.shape
    for name, t, dtype, shape in (('poses', poses, torch.float32, (T, N, 3, B)),
                                  ('cosa', cosa, torch.float32, (T, N, B)),
                                  ('sina', sina, torch.float32, (T, N, B)),
                                  ('is_circle', is_circle, torch.bool, (B, N))):
      if not t.is_cuda or t.device != poses.device:
        raise ValueError(f'{name} must lie on the same CUDA device as poses')
      if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f'{name} must be {dtype} {shape}, got {t.dtype} '
                         f'{tuple(t.shape)}')
      if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    K = self.consts
    out = torch.empty((T, B, self.height), dtype=torch.int32,
                      device=poses.device)
    if T * B == 0:
      return out
    geo = cuda_raster.launch_geometry(spec, T * B, self.height)
    stream = torch.cuda.current_stream(poses.device).cuda_stream
    with torch.cuda.device(poses.device):   # launch on the tensors' card
      err = _lib()(poses.data_ptr(), cosa.data_ptr(), sina.data_ptr(),
                   is_circle.data_ptr(), *K.pointers(poses.device), T, B, N,
                   K.verts, self.height, self.width, K.dmax, K.scale,
                   geo.nv, geo.lanes, geo.threads, geo.shared,
                   out.data_ptr(), stream)
    if err != 0:
      raise RuntimeError(f'traj_raster launch failed: cudaError {err}')
    trace.count('traj_raster.launches')
    return out


_RENDERS = {}


def make_traj_render(spec: WorldSpec, width: int, height: int) -> TrajRender:
  """Trajectory render for `spec` at W x H (W <= 32); cached (the cache holds
  the spec, so its id is never reused)."""
  key = (id(spec), width, height)
  hit = _RENDERS.get(key)
  if hit is None or hit.spec is not spec:
    hit = _RENDERS[key] = TrajRender(spec, width, height)
  return hit
