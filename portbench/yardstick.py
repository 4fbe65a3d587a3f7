"""The benchmark's frozen arithmetic: the H100's published peaks and the
operation and byte counts of the port's kernels, copied here from the
port's measurement scripts (research/scripts/roofline.py:
`mega_flops_per_substep`, `contacts_per_world`, `state_bytes`,
`mega_bytes`, `mega_bound`; chip_smoke.py: `raster_flops`, `traj_bound`)
and held fixed, so a change to the program cannot move the yardstick.
A spec here is the reference's compiled world (portbench/reference), which
has the port's field names; a state is any object with the WorldState
fields as tensors. The learned env's model operations are counted from
the shapes of the published nets (`dream_step_flops`), as multiply-adds
x 2 of their matmuls and convolutions.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # float32 outside the tensor cores
BF16_FLOPS = 989e12           # dense bfloat16 on the tensor cores

CIRCLE = 0

STATE_FIELDS = ('c', 'a', 'v', 'w', 'is_circle', 'sleep_time', 'wc_imp',
                'wc_id', 'pc_imp', 'pc_id', 'j_imp', 'j_mot', 'j_lim',
                'j_ref', 'prev_motor', 'j_state', 'ep_t')


def mega_flops_per_substep(spec, contacts):
  """Float operations of one world-substep of the rollout megakernel,
  counted from csrc/physics_stages.cuh (adds, multiplies, divides, square
  roots; cosf and sinf as one each). V_i: polygon vertices of body i (0 for
  circles); C: touching contact points per world; vi, pi: velocity and
  position iterations; jn joints, P valid pairs, nw walls, R label rounds:
    sum_i (7 + 14 V_i)                 integrate, cos/sin, world polygon
  + nw * sum_i (5 V_i + 12)            wall narrowphase
  + sum_pairs (8 V_a V_b + 120)        pair narrowphase (SAT, clip, init)
  + C (45 + 45 vi + 35 pi)             contact init + warm start, sweeps, NGS
  + jn (60 + 87 vi + 55 pi)            joint init + warm start, sweeps, NGS
  + 10 n + 2 R (jn + P)                sleeping
  with pi = 1: the kernel does not report how many NGS iterations ran, so
  the count takes the fewest the exit allows."""
  V = [0 if int(k) == CIRCLE else int(v)
       for k, v in zip(spec.shape_static, spec.nverts)]
  nw = len(spec.wall_offset)
  pairs = [(int(a), int(b)) for a, b, ok in
           zip(spec.pair_a, spec.pair_b, spec.pair_valid) if ok]
  rounds = max(1, int(np.ceil(np.log2(max(spec.n, 2))))) + 1
  vi, pi = spec.vel_iters, 1
  return (sum(7 + 14 * v for v in V) + nw * sum(5 * v + 12 for v in V)
          + sum(8 * V[a] * V[b] + 120 for a, b in pairs)
          + contacts * (45 + 45 * vi + 35 * pi)
          + spec.jn * (60 + 87 * vi + 55 * pi)
          + 10 * spec.n + 2 * rounds * (spec.jn + len(pairs)))


def contacts_per_world(state):
  """Touching contact points per world of a state (walls and pairs)."""
  B = state.c.shape[0]
  return float(((state.wc_id >= 0).sum() + (state.pc_id >= 0).sum()) / B)


def state_bytes(state):
  """Bytes of a state batch."""
  return sum(getattr(state, f).numel() * getattr(state, f).element_size()
             for f in STATE_FIELDS)


def mega_bytes(spec, state, B, T):
  """Bytes the megakernel moves in one launch of T steps over B worlds: the
  state read and written once, the (T, B, J) motor speeds read once, the
  (T, N, 3, B) pose stream written once."""
  return (2 * state_bytes(state) + T * B * len(spec.j_parent) * 4
          + T * spec.n * 3 * B * 4)


def mega_flops(spec, final, B, T):
  """Operations of one launch: the per-substep count with C the contact
  points touching in the launch's final state, x substeps x T x B."""
  return (mega_flops_per_substep(spec, contacts_per_world(final))
          * spec.substeps * T * B)


def mega_bound(spec, final, B, T):
  """Least time of one megakernel launch: (bound ms, 'bytes' |
  'operations', flops)."""
  flops = mega_flops(spec, final, B, T)
  t_bytes = mega_bytes(spec, final, B, T) / HBM_BYTES_PER_S * 1e3
  t_ops = flops / FP32_FLOPS * 1e3
  by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
  return (*by, flops)


def raster_flops(spec, is_circle, height):
  """Float operations of one frame per world for these shape flags: per
  drawn polygon the b2Mul transform (8 + 10 per vertex), one divide per edge
  and an edge crossing (mul + add) per edge and row; per drawn circle its
  bbox (8)."""
  shape = np.asarray(spec.shape_static)[None]
  ic = np.asarray(is_circle.cpu())
  circ = (shape == 0) | ((shape == 2) & ic)
  nv = np.asarray(spec.nverts, np.float64)[None]
  poly_ops = 8 + 10 * nv + nv + 2 * nv * height
  return float(np.where(circ, 8.0, np.broadcast_to(poly_ops, ic.shape)).sum())


def traj_bound(spec, is_circle, T, height, tables):
  """Least time of one trajectory-raster launch: (bound ms, 'bytes' |
  'operations'). Bytes: x, y, cos and sin of T frames, is_circle once per
  world and the spec tables read once, the (T, B, H) int32 rows written
  once. Operations: raster_flops, T times."""
  B, N = is_circle.shape
  nbytes = (T * B * N * (8 + 8) + B * N + T * B * height * 4
            + sum(t.numel() * t.element_size() for t in tables.values()))
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = T * raster_flops(spec, is_circle, height) / FP32_FLOPS * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _conv(h, w, cin, cout, k):
  return 2 * h * w * cin * cout * k * k


def _dense(n_in, n_out, rows=1):
  return 2 * rows * n_in * n_out


def bvae_encode_flops(s):
  """Multiply-adds x 2 of the BVAE encoder on one frame: the proprio MLP
  (P -> n -> n -> n), the 3x3 convolutions at H x W, H/2 x W/2 and
  H/4 x W/4 (a stride-2 convolution into each lower size, a residual
  block's two and its embedding projection at each), the 1x1 projection
  to vqD."""
  H, W, P, n, nf = s['H'], s['Wd'], s['P'], s['hidden'], s['nfilter']
  f = _dense(P, n) + 2 * _dense(n, n) + _conv(H, W, 1, nf, 3)
  for lvl in range(3):
    h, w = -(-H // 2 ** lvl), -(-W // 2 ** lvl)
    if lvl:
      f += _conv(h, w, nf, nf, 3)
    f += 2 * _conv(h, w, nf, nf, 3) + _dense(n, nf)
  return f + _conv(s['zH'], s['zW'], nf, s['vqD'], 1)


def bvae_decode_flops(s):
  """Of the BVAE decoder on one code grid: the MLP to proprio and the 3x3
  convolutions after each x2 upsample and at the frame's size."""
  zH, zW, D, n, nf = s['zH'], s['zW'], s['vqD'], s['hidden'], s['nfilter']
  Z = zH * zW * D
  return (_dense(Z, n) + _dense(n, n) + _dense(n, s['P'])
          + _conv(2 * zH, 2 * zW, D, nf, 3) + _conv(4 * zH, 4 * zW, nf, nf, 3)
          + _conv(4 * zH, 4 * zW, nf, nf, 3) + _conv(4 * zH, 4 * zW, nf, 1, 3))


def fbt_flops(s):
  """Of one FBT forward over the W positions of a window: the code and
  action embeddings, per layer the qkv, the full W x W scores and their
  product with the values, the output projection and the 4x MLP, the
  token head."""
  E, L, W = s['n_embed'], s['n_layer'], s['W']
  Z = s['zH'] * s['zW'] * s['vqD']
  f = _dense(Z, E // 2, W) + _dense(s['A'], E // 2, W) + _dense(E, Z, W)
  layer = (_dense(E, 3 * E, W) + 2 * (2 * W * W * E) + _dense(E, E, W)
           + _dense(E, 4 * E, W) + _dense(4 * E, E, W))
  return f + L * layer


def policy_flops(s):
  """Of the PPO actor and critic on one observation."""
  P, h, A = s['P'], s['ppo_hidden'], s['A']
  mlp = lambda out: _dense(2 * P, h) + _dense(h, h) + _dense(h, out)
  return 2 * _dense(P, P) + mlp(A) + mlp(1)


def dream_step_flops(s):
  """Model operations of one dream step of all B envs: the window's W
  frames encoded, the FBT over the window, one code grid decoded, the
  policy and the value."""
  return s['B'] * (s['W'] * bvae_encode_flops(s) + fbt_flops(s)
                   + bvae_decode_flops(s) + policy_flops(s))
