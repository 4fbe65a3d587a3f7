"""The routed experts of a mixture-of-experts layer on the card: the two
grouped GEMMs over the experts a layer holds (`csrc/moe_experts.cu`,
CUDA C++ for Hopper: gate and up fused with silu * mul, then down) and the
weighted combine (`_combine_kernel`, Triton: an elementwise pass and a
k-way sum).

They replace no TPU kernel: the JAX package has no mixture of experts.
They were added for DeepSeek-V2's MoE layers (`dsv2.MoE`): at the dream's
3,200 tokens a step each of 64 experts takes about 300 token-slots in each
of 26 layers, and a loop over experts would enqueue some 5,000 launches a
step and synchronise with the host once a layer for the rows each expert
takes. What bounds the GEMMs, and their design, is in the CUDA source. The
routing, the sort of the token-slots by expert and the counts stay on the
device (`plan`): nothing is read back, so the launch queue never drains.
The GEMM kernels derive the tile list from the counts (`tile_table`: each
expert's token tiles, of a width that follows its count; `rows_tiled`
the rows they cover); `moe_gate_up_kernel` gathers its rows straight from
the layer's input by token (no permuted copy) and writes silu(gate) * up
once, rounded to bfloat16; `moe_down_kernel` writes each slot's output
row to the slot's place in token order; `_combine_kernel` sums a token's k
rows in float32 with the router's weights and rounds, adds the shared
experts' output and rounds, adds the residual and rounds, as the published
model rounds each sum. Tile shapes are fixed (no tuning at set-up).

On the CPU `moe_experts` runs `moe_experts_plain`, the same plan and the
same arithmetic tile by tile in torch. Launches count under
`moe_gate_up.launches`, `moe_down.launches`, `moe_combine.launches`
(boxlcd_tpu_torch.trace).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from boxlcd_tpu_torch import _build, trace

TN = 128           # the most token rows a GEMM tile (csrc/moe_experts.cu)
COMBINE_BH = 512
_KERNELS = {}
_READY = set()     # devices whose kernels have their shared memory set


def plan(idx, n_experts, counts=None):
  """The device-side schedule of the token-slots (N, k expert ids among
  `n_experts`): (order (N*k,) int64, the flat slot (token * k + j) of each
  sorted place, experts' slots contiguous and in expert order; counts
  (n_experts,) int32, written into `counts` where given). No host
  synchronisation. The kernels derive the rest from the counts
  (`tile_table`)."""
  if n_experts > 256:
    raise ValueError(f'{n_experts} experts: the sort keys are 8-bit')
  flat = idx.reshape(-1)
  order = torch.argsort(flat.to(torch.uint8), stable=True)
  if counts is None:
    counts = torch.zeros(n_experts, dtype=torch.int32, device=idx.device)
  else:
    counts.zero_()
  counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
  return order, counts


def tile_rows(counts):
  """(each expert's token-tile width, its number of token tiles) for the
  counts, as the kernels choose them: ceil(c / TN) tiles of
  ceil(c / tiles) rows rounded up to 8, the last tile the rest (one tile
  fewer where the rounding leaves nothing for the last); 0 and 0 for an
  expert with no rows."""
  most = ((counts + TN - 1) // TN).clamp(min=1)
  w = ((counts + most - 1) // most + 7) // 8 * 8
  return w, (counts + w - 1).clamp(min=0) // w.clamp(min=1)


def tile_table(counts):
  """(each expert's cumulative token tiles, its first place, its tile
  width): what the kernels compute from the counts. Tile j of expert e
  holds its rows j * w .. min((j + 1) * w, count) - 1, rounded up to 8
  rows for the tensor cores."""
  w, nt = tile_rows(counts)
  return torch.cumsum(nt, 0), torch.cumsum(counts, 0) - counts, w


def rows_tiled(counts):
  """The token rows the kernels' tiles cover for the counts (..., E),
  padding included, summed over the last axis: each tile runs the tensor
  cores over its rows rounded up to 8 (wgmma's N), every full tile the
  width, the last the rest. On the device, no synchronisation."""
  w, nt = tile_rows(counts)
  full = (nt - 1).clamp(min=0) * w
  return (full + (counts - full + 7) // 8 * 8).sum(-1)


def max_row_tiles(slots, experts):
  """The most token tiles any routing of `slots` slots over `experts`
  experts can give (the kernels' grid is sized from it)."""
  return -(-slots // TN) + experts


def moe_experts_plain(x, w, idx, wg, wu, wd, shared=None, residual=None,
                      counts=None):
  """`moe_experts` in torch, tile table and all: each expert's rows taken
  by the plan, gate and up in float32, silu(gate) * up rounded once to x's
  dtype, down in float32 rounded to the dtype, the k rows of a token
  summed in float32 with their weights, rounded, plus `shared`, rounded,
  plus `residual`, rounded. Reads the plan back to the host (CPU use)."""
  N, k = idx.shape
  E = wg.shape[0]
  order, counts = plan(idx, E, counts)
  ends, first, width = (t.tolist() for t in tile_table(counts))
  y = torch.zeros((N * k, x.shape[1]), dtype=x.dtype, device=x.device)
  for t in range(max_row_tiles(N * k, E)):
    e = sum(1 for v in ends if v <= t)
    if e >= E:
      continue
    r0 = (t - (ends[e - 1] if e else 0)) * width[e]
    rows = torch.arange(r0, min(r0 + width[e], int(counts[e])),
                        device=x.device)
    slots = order[first[e] + rows]
    xe = x[slots // k].float()
    h = (F.silu(xe @ wg[e].float().T) * (xe @ wu[e].float().T)).to(x.dtype)
    y[slots] = (h.float() @ wd[e].float().T).to(x.dtype)
  out = (y.float() * w.reshape(-1, 1).float()).reshape(N, k, -1).sum(1)
  out = out.to(x.dtype)
  if shared is not None:
    out = (out.float() + shared.float()).to(x.dtype)
  if residual is not None:
    out = (residual.float() + out.float()).to(x.dtype)
  return out, counts


def _combine_kernel(y_ptr, w_ptr, shared_ptr, res_ptr, out_ptr, H,
                    K_TOP: tl.constexpr, HAS_SHARED: tl.constexpr,
                    HAS_RES: tl.constexpr, BLOCK_H: tl.constexpr):
  """One token's k expert rows summed in float32 with the router's weights,
  rounded; plus the shared experts', rounded; plus the residual,
  rounded."""
  n = tl.program_id(0).to(tl.int64)
  cols = tl.program_id(1) * BLOCK_H + tl.arange(0, BLOCK_H)
  cmask = cols < H
  acc = tl.zeros((BLOCK_H,), dtype=tl.float32)
  for j in tl.static_range(K_TOP):
    wj = tl.load(w_ptr + n * K_TOP + j)
    yj = tl.load(y_ptr + (n * K_TOP + j) * H + cols, mask=cmask, other=0.0)
    acc += wj * yj.to(tl.float32)
  dt = out_ptr.dtype.element_ty
  s = acc.to(dt)
  if HAS_SHARED:
    sh = tl.load(shared_ptr + n * H + cols, mask=cmask, other=0.0)
    s = (s.to(tl.float32) + sh.to(tl.float32)).to(dt)
  if HAS_RES:
    r = tl.load(res_ptr + n * H + cols, mask=cmask, other=0.0)
    s = (r.to(tl.float32) + s.to(tl.float32)).to(dt)
  tl.store(out_ptr + n * H + cols, s, mask=cmask)


def _lib(device):
  """The GEMM kernels' library (built at first use, `_build`), its shared
  memory set for `device` before the first launch there."""
  lib = _build.load('moe_experts')
  if lib.moe_experts_launch.argtypes is None:
    lib.moe_experts_launch.argtypes = ([ctypes.c_void_p] * 8 +
                                       [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.moe_experts_launch.restype = ctypes.c_int
    lib.moe_experts_init.restype = ctypes.c_int
    lib.moe_experts_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.moe_experts_tiles.restype = None
    tn, i_mult, h_mult = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.moe_experts_tiles(ctypes.byref(tn), ctypes.byref(i_mult),
                          ctypes.byref(h_mult))
    if tn.value != TN:
      raise RuntimeError(f'moe_experts.cu tiles {tn.value} token rows, the '
                         f'plan {TN}')
    lib.i_mult, lib.h_mult = i_mult.value, h_mult.value
  if device not in _READY:
    with torch.cuda.device(device):
      err = lib.moe_experts_init()
    if err != 0:
      raise RuntimeError(f'moe_experts: shared memory not set: cudaError '
                         f'{err}')
    _READY.add(device)
  return lib


def _triton_kernels():
  """The combine kernel, jitted at the first launch (compiled into Triton's
  cache, TRITON_CACHE_DIR). The kernel above names `tl`, bound here: the
  module imports without Triton (the CPU has none)."""
  if not _KERNELS:
    import triton
    import triton.language
    globals()['tl'] = triton.language
    _KERNELS['combine'] = triton.jit(_combine_kernel)
  return _KERNELS


def moe_experts(x, w, idx, wg, wu, wd, shared=None, residual=None,
                counts=None):
  """The routed experts' part of a MoE layer for rows x (N, H): expert ids
  idx (N, k) among the E experts whose stacked weights are given (wg, wu
  (E, I, H), wd (E, H, I)) and router weights w (N, k) float32; `shared`
  and `residual` (N, H) or None. Returns (sum_k w_k E_k(x) rounded to x's
  dtype, plus `shared`, plus `residual`, each sum rounded, (N, H); the
  experts' token counts (E,) int32, written into `counts` where given). On
  the card, the plan then three launches (two GEMM passes, the combine);
  no host synchronisation."""
  if x.device.type != 'cuda':
    return moe_experts_plain(x, w, idx, wg, wu, wd, shared, residual, counts)
  N, H = x.shape
  k = idx.shape[1]
  E, I = wg.shape[0], wg.shape[1]
  for t in (x, wg, wu, wd):
    if t.dtype != torch.bfloat16 or not t.is_contiguous() or \
        t.device != x.device:
      raise ValueError('moe_experts takes contiguous bfloat16 inputs on one '
                       f'card, got {t.dtype} {tuple(t.shape)} on {t.device}')
  if w.dtype != torch.float32 or idx.dtype != torch.int64 or \
      not (w.is_contiguous() and idx.is_contiguous()) or w.shape != idx.shape:
    raise ValueError(f'moe_experts takes contiguous float32 weights and '
                     f'int64 ids of one shape, got {w.dtype} {idx.dtype}')
  if wg.shape != (E, I, H) or wu.shape != (E, I, H) or wd.shape != (E, H, I):
    raise ValueError(f'expert weights {tuple(wg.shape)} {tuple(wu.shape)} '
                     f'{tuple(wd.shape)} for x {tuple(x.shape)}')
  for t in (shared, residual):
    if t is not None and (t.shape != x.shape or t.dtype != x.dtype or
                          not t.is_contiguous()):
      raise ValueError(f'moe_experts: shared/residual {t.dtype} '
                       f'{tuple(t.shape)} for x {tuple(x.shape)}')
  lib = _lib(x.device)
  if H % lib.h_mult or I % lib.i_mult:
    raise ValueError(f'moe_experts: hidden {H} and expert width {I} must be '
                     f'multiples of {lib.h_mult} and {lib.i_mult}')
  order, counts = plan(idx, E, counts)
  h = torch.empty((N * k, I), dtype=x.dtype, device=x.device)
  y = torch.empty((N * k, H), dtype=x.dtype, device=x.device)
  err = lib.moe_experts_launch(
      x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
      h.data_ptr(), y.data_ptr(), order.data_ptr(), counts.data_ptr(), E, k,
      N * k, H, I, torch.cuda.current_stream(x.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f'moe_experts launch failed: {err} (a cudaError, or '
                       f'-1000 - a CUresult of a tensor map)')
  trace.count('moe_gate_up.launches')
  trace.count('moe_down.launches')
  out = torch.empty_like(x)
  _triton_kernels()['combine'][(N, -(-H // COMBINE_BH))](
      y, w, x if shared is None else shared,
      x if residual is None else residual, out, H, K_TOP=k,
      HAS_SHARED=shared is not None, HAS_RES=residual is not None,
      BLOCK_H=COMBINE_BH, num_warps=4)
  trace.count('moe_combine.launches')
  return out, counts
