"""Fixed-shape rigid-body step in torch, batched over a leading worlds axis.

Implements the Box2D solver pipeline the reference leans on
(reference: boxLCD/world_env.py:446-452 — `Step(1/(3*fps), 180, 60)` x3):

  integrate velocities -> narrowphase -> warm start -> sequential-impulse
  velocity iterations (joints, then contacts, Gauss-Seidel over constraint
  slots) -> integrate positions -> non-linear Gauss-Seidel position
  iterations (joint limits/points + contact penetration).

All shapes are static: contacts live in fixed arenas (bodies x walls x 2 and
precompiled body pairs x 2) with validity masks. Every tensor carries the
worlds axis first; the Gauss-Seidel sweeps are Python loops over the spec's
static constraint slots, each slot one batch of elementwise ops over worlds.
The arithmetic follows boxlcd_tpu's engine/physics.py op for op, in float32
and with no matrix products (so TF32 never applies on the card).

Slots the spec pads (the disabled joint of a jointless world, the invalid
pair of a pairless one) carry zero masses and impulses, so the sweeps skip
them: their contribution is exactly zero. Scatter-adds with repeated body
indices (warm start) use `index_add_`, whose float sums may run in another
order on the card than on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.engine import collision
from boxlcd_tpu_torch.engine.collision import _sel, dot, norm, rot_apply
from boxlcd_tpu_torch.engine.spec import WorldSpec

# Box2D b2Settings constants
BAUMGARTE = 0.2
LINEAR_SLOP = 0.005
ANGULAR_SLOP = 2.0 / 180.0 * np.pi
MAX_LINEAR_CORRECTION = 0.2
MAX_ANGULAR_CORRECTION = 8.0 / 180.0 * np.pi
VELOCITY_THRESHOLD = 1.0
TIME_TO_SLEEP = 0.5                      # b2_timeToSleep
LIN_SLEEP_TOL_SQ = 0.01 ** 2             # b2_linearSleepTolerance^2
ANG_SLEEP_TOL_SQ = (2.0 / 180.0 * 3.14159265) ** 2

# step_world_motor's per-world counters (trace.world_counts), in its order
COUNTS = ('physics.ngs_iters', 'physics.world_substeps')


def cross_sv(w, r):
  """scalar x vector: w x r = (-w*ry, w*rx)."""
  return torch.stack([-w * r[..., 1], w * r[..., 0]], -1)


def cross_vv(a, b):
  return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def perp(n):
  """tangent = cross(n, 1) = (ny, -nx)."""
  return torch.stack([n[..., 1], -n[..., 0]], -1)


def _dot_c(x, n):
  """dot(x, n) for a constant 2-vector n of Python floats."""
  return x[..., 0] * n[0] + x[..., 1] * n[1]


def _times_c(d, n):
  """d[..., None] * n for a constant 2-vector n of Python floats."""
  return torch.stack([d * n[0], d * n[1]], -1)


def _block_lcp(b1, b2, a1, a2, k11, k22, k12, nm1, nm2):
  """Box2D's 2-point normal block solve: the 2x2 LCP case enumeration from
  b2ContactSolver::SolveVelocityConstraints. b1/b2 are the biased relative
  normal velocities at the two points, a1/a2 the accumulated impulses, K the
  2-point effective-mass matrix, nm1/nm2 the per-point normal masses.
  Returns impulse deltas (d1, d2); if no case holds, Box2D leaves the
  impulses unchanged (delta 0). Elementwise over any batch shape."""
  b1p = b1 - (k11 * a1 + k12 * a2)
  b2p = b2 - (k12 * a1 + k22 * a2)
  det = k11 * k22 - k12 * k12
  idet = torch.where(torch.abs(det) > 1e-12,
                     1.0 / torch.where(det == 0, 1.0, det), 0.0)
  # case 1: both points active -> x = -K^-1 b'
  x1_1 = -(k22 * b1p - k12 * b2p) * idet
  x2_1 = -(k11 * b2p - k12 * b1p) * idet
  ok1 = (x1_1 >= 0.0) & (x2_1 >= 0.0)
  # case 2: point 2 inactive
  x1_2 = -nm1 * b1p
  ok2 = (x1_2 >= 0.0) & (k12 * x1_2 + b2p >= 0.0)
  # case 3: point 1 inactive
  x2_3 = -nm2 * b2p
  ok3 = (x2_3 >= 0.0) & (k12 * x2_3 + b1p >= 0.0)
  # case 4: both inactive
  ok4 = (b1p >= 0.0) & (b2p >= 0.0)
  x1 = torch.where(ok1, x1_1, torch.where(
      ok2, x1_2, torch.where(ok3, 0.0, torch.where(ok4, 0.0, a1))))
  x2 = torch.where(ok1, x2_1, torch.where(
      ok2, 0.0, torch.where(ok3, x2_3, torch.where(ok4, 0.0, a2))))
  return x1 - a1, x2 - a2


def _joint_block(state, cd1x, cd1y, cd2, jlim, k11, k12, k13, k22, k23, k33):
  """Box2D 2.3's coupled revolute limit+point velocity solve
  (b2RevoluteJoint::SolveVelocityConstraints): when the limit is active
  (state 1=lower/2=upper/3=equal), point (x,y) and limit (z) are one 3x3
  system with case-wise clamping that re-solves the reduced 2x2 when the
  accumulated limit impulse would cross zero; when inactive (0), the point
  solves alone. K is the symmetric 3x3 effective mass (k13=ez.x, k23=ez.y).
  Elementwise over any batch shape. Returns (dx, dy, dz) impulse deltas."""
  # -- full 3x3 solve: impulse = -K^-1 Cdot (Cramer on the symmetric K)
  a11 = k22 * k33 - k23 * k23
  a12 = k13 * k23 - k12 * k33
  a13 = k12 * k23 - k13 * k22
  a22 = k11 * k33 - k13 * k13
  a23 = k13 * k12 - k11 * k23
  a33 = k11 * k22 - k12 * k12
  det3 = k11 * a11 + k12 * a12 + k13 * a13
  det3 = torch.where(torch.abs(det3) > 1e-12, det3, 1.0)
  ix = -(a11 * cd1x + a12 * cd1y + a13 * cd2) / det3
  iy = -(a12 * cd1x + a22 * cd1y + a23 * cd2) / det3
  iz = -(a13 * cd1x + a23 * cd1y + a33 * cd2) / det3
  # -- reduced 2x2 re-solve when the limit accumulator would cross zero
  det2 = k11 * k22 - k12 * k12
  det2 = torch.where(torch.abs(det2) > 1e-12, det2, 1.0)
  r1 = -cd1x + jlim * k13
  r2 = -cd1y + jlim * k23
  rx = (k22 * r1 - k12 * r2) / det2
  ry = (k11 * r2 - k12 * r1) / det2
  new_z = jlim + iz
  lo_clamp = (state == 1) & (new_z < 0.0)
  hi_clamp = (state == 2) & (new_z > 0.0)
  clamp = lo_clamp | hi_clamp
  dx_act = torch.where(clamp, rx, ix)
  dy_act = torch.where(clamp, ry, iy)
  dz_act = torch.where(clamp, -jlim, iz)
  # -- inactive limit: plain point 2x2
  px = -(k22 * cd1x - k12 * cd1y) / det2
  py = -(k11 * cd1y - k12 * cd1x) / det2
  active = state > 0
  dx = torch.where(active, dx_act, px)
  dy = torch.where(active, dy_act, py)
  dz = torch.where(active, dz_act, 0.0)
  return dx, dy, dz


class WorldState(NamedTuple):
  """Dynamic state of a batch of worlds; every field has the worlds axis
  first (shapes below are per world), with boxlcd_tpu's field names."""
  c: torch.Tensor          # (N, 2) world center-of-mass positions
  a: torch.Tensor          # (N,)   angles
  v: torch.Tensor          # (N, 2) linear velocities (of com)
  w: torch.Tensor          # (N,)   angular velocities
  is_circle: torch.Tensor  # (N,)   bool, per-episode shape choice
  ep_t: torch.Tensor       # ()     int32 step counter
  # warm-start caches (persist across substeps and steps)
  wc_imp: torch.Tensor     # (N, W, 2, 2) wall-contact [pn, pt]
  wc_id: torch.Tensor      # (N, W, 2) int32
  pc_imp: torch.Tensor     # (P, 2, 2) pair-contact [pn, pt]
  pc_id: torch.Tensor      # (P, 2) int32
  j_imp: torch.Tensor      # (J, 2) joint point impulse
  j_mot: torch.Tensor      # (J,) motor impulse
  j_lim: torch.Tensor      # (J,) limit impulse (Box2D 2.3 single accumulator)
  j_state: torch.Tensor    # (J,) int32 limit state: 0 inactive, 1 lower, 2 upper, 3 equal
  j_ref: torch.Tensor      # (J,) reference angle, set at reset (pybox2d's
                           # revoluteJointDef initializes referenceAngle to
                           # the spawn relative angle)
  sleep_time: torch.Tensor  # (N,) seconds below the sleep velocity tolerances
  prev_motor: torch.Tensor  # (J,) last motor speeds (changes wake the island,
                            # as pybox2d's SetMotorSpeed does)


_INT_FIELDS = ('ep_t', 'wc_id', 'pc_id', 'j_state')


def init_state(spec: WorldSpec, batch: int, device) -> WorldState:
  n = spec.n
  nw = len(spec.wall_offset)
  p = len(spec.pair_a)
  j = len(spec.j_parent)
  z = lambda *s: torch.zeros((batch, *s), device=device)
  iz = lambda *s: torch.zeros((batch, *s), dtype=torch.int32, device=device)
  return WorldState(
      c=z(n, 2), a=z(n), v=z(n, 2), w=z(n),
      is_circle=torch.as_tensor(spec.shape_static == 0, device=device)
      .expand(batch, n).clone(),
      ep_t=iz(),
      wc_imp=z(n, nw, 2, 2), wc_id=iz(n, nw, 2) - 1,
      pc_imp=z(p, 2, 2), pc_id=iz(p, 2) - 1,
      j_imp=z(j, 2), j_mot=z(j), j_lim=z(j), j_state=iz(j),
      j_ref=z(j), sleep_time=z(n), prev_motor=z(j))


def state_from_numpy(arrays, device) -> WorldState:
  """WorldState from a dict (or WorldState-like) of numpy arrays with the
  boxlcd_tpu field names, batched over a leading worlds axis."""
  get = arrays.__getitem__ if isinstance(arrays, dict) else \
      lambda k: getattr(arrays, k)
  out = {}
  for f in WorldState._fields:
    x = np.asarray(get(f))
    if f == 'is_circle':
      x = x.astype(bool)
    elif f in _INT_FIELDS:
      x = x.astype(np.int32)
    else:
      x = x.astype(np.float32)
    out[f] = torch.as_tensor(x, device=device)
  return WorldState(**out)


def state_to_numpy(state: WorldState) -> dict:
  """dict of numpy arrays with the boxlcd_tpu field names."""
  return {f: getattr(state, f).cpu().numpy() for f in WorldState._fields}


# -- device copies of the spec's tables ---------------------------------------

class Consts:
  """The spec's numpy tables as tensors on one device, plus the derived
  per-body and per-slot constants the step reuses. Derived float constants
  are computed in numpy float32, as boxlcd_tpu's XLA program folds them."""

  def __init__(self, spec: WorldSpec, device):
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    lng = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    bol = lambda x: torch.as_tensor(np.asarray(x, bool), device=device)
    dt = spec.dt
    pa, pb = spec.pair_a, spec.pair_b
    self.inv_m0, self.inv_m1 = f32(spec.inv_m[:, 0]), f32(spec.inv_m[:, 1])
    self.inv_i0, self.inv_i1 = f32(spec.inv_i[:, 0]), f32(spec.inv_i[:, 1])
    self.lc0 = f32(spec.local_center[:, 0])
    self.lc1 = f32(spec.local_center[:, 1])
    self.dtg = f32(dt * spec.gravity)
    self.lin_div = f32(1.0 + dt * spec.lin_damp)
    self.ang_div = f32(1.0 + dt * spec.ang_damp)
    self.verts_com = f32(spec.verts - spec.local_center[:, 1][:, None, :])
    self.normals = f32(spec.normals)
    self.vmask = bol(np.arange(spec.verts.shape[1])[None, :]
                     < spec.nverts[:, None])
    self.radius = f32(spec.radius)
    self.wall_n = f32(spec.wall_normal)
    self.wall_off = f32(spec.wall_offset)
    self.pair_a, self.pair_b = lng(pa), lng(pb)
    self.pair_valid = bol(spec.pair_valid)
    self.w_mu = f32(np.sqrt(0.2 * spec.friction))
    self.w_e = f32(spec.restitution)
    self.p_mu = f32(np.sqrt(spec.friction[pa] * spec.friction[pb]))
    self.p_e = f32(np.maximum(spec.restitution[pa], spec.restitution[pb]))
    self.j_pa, self.j_ch = lng(spec.j_parent), lng(spec.j_child)
    self.j_anchor_a, self.j_anchor_b = f32(spec.j_anchor_a), f32(spec.j_anchor_b)
    self.j_lower, self.j_upper = f32(spec.j_lower), f32(spec.j_upper)
    self.j_limited = bol(spec.j_limited)
    self.j_valid = bol(spec.j_valid)
    self.j_validf = f32(spec.j_valid)
    self.j_equal = bol(spec.j_limited & (spec.j_lower == spec.j_upper))
    self.j_cap = (spec.j_torque * dt).astype(np.float32)   # host floats
    self.j_speed = f32(spec.j_speed)
    self.a_idx = lng(np.maximum(spec.j_act, 0))
    self.has_act = f32(spec.j_act >= 0)
    adj = np.zeros((spec.n, spec.n), bool)
    for j in range(spec.jn):
      adj[spec.j_parent[j], spec.j_child[j]] = True
      adj[spec.j_child[j], spec.j_parent[j]] = True
    self.adj_joint = bol(adj)
    self.body_ids = torch.arange(spec.n, device=device)


_CONSTS = {}


def consts(spec: WorldSpec, device) -> Consts:
  """Cached Consts of `spec` on `device` (the cache holds the spec, so its
  id is never reused while the entry lives)."""
  device = torch.device(device)
  key = (id(spec), str(device))
  hit = _CONSTS.get(key)
  if hit is None or hit[0] is not spec:
    hit = _CONSTS[key] = (spec, Consts(spec, device))
  return hit[1]


def body_inv_mass(K: Consts, is_circle):
  return (torch.where(is_circle, K.inv_m0, K.inv_m1),
          torch.where(is_circle, K.inv_i0, K.inv_i1))


def local_center(K: Consts, is_circle):
  return torch.where(is_circle[..., None], K.lc0, K.lc1)


def origin_pos(spec: WorldSpec, state):
  """Body-origin positions (what Box2D reports as body.position); state
  needs is_circle, c and a."""
  K = consts(spec, state.c.device)
  lc = local_center(K, state.is_circle)
  return state.c - rot_apply(torch.cos(state.a), torch.sin(state.a), lc)


def com_from_origin(spec: WorldSpec, is_circle, origin, angle):
  K = consts(spec, origin.device)
  lc = local_center(K, is_circle)
  return origin + rot_apply(torch.cos(angle), torch.sin(angle), lc)


def _match_impulses(new_ids, touch, old_ids, old_imp):
  """Carry accumulated impulses for persisting contact points (warm start)."""
  # (..., 2 new, 2 old) int id equality; old impulses were zeroed if not touching
  eq = (new_ids[..., :, None] == old_ids[..., None, :]).to(old_imp.dtype)
  imp = (eq[..., :, :, None] * old_imp[..., None, :, :]).sum(-2)
  return torch.where(touch[..., None], imp, 0.0)


class SolveBundle(NamedTuple):
  """Everything the velocity-iteration loop consumes/produces (worlds first)."""
  # mutable carry
  v: torch.Tensor          # (N, 2)
  w: torch.Tensor          # (N,)
  j_imp: torch.Tensor      # (J, 2)
  j_mot: torch.Tensor      # (J,)
  j_lim: torch.Tensor      # (J,)
  wc: torch.Tensor         # (N, W, 2, 2)
  pc: torch.Tensor         # (P, 2, 2)
  # constants for this substep
  inv_m: torch.Tensor      # (N,)
  inv_i: torch.Tensor      # (N,)
  j_rA: torch.Tensor       # (J, 2)
  j_rB: torch.Tensor       # (J, 2)
  j_axmass: torch.Tensor   # (J,)
  j_state: torch.Tensor    # (J,) int32
  j_mA: torch.Tensor       # (J,)
  j_mB: torch.Tensor
  j_iA: torch.Tensor
  j_iB: torch.Tensor
  motor_speed: torch.Tensor  # (J,)
  w_rB: torch.Tensor       # (N, W, 2, 2)
  w_nmass: torch.Tensor    # (N, W, 2)
  w_tmass: torch.Tensor    # (N, W, 2)
  w_bias: torch.Tensor     # (N, W, 2)
  w_mu: torch.Tensor       # (N,)
  w_k: torch.Tensor        # (N, W, 2) raw normal-direction effective masses k11,k22
  w_k12: torch.Tensor      # (N, W) off-diagonal of the 2-point K matrix
  w_block: torch.Tensor    # (N, W) bool: solve both points as a 2x2 block
  p_n: torch.Tensor        # (P, 2)
  p_rA: torch.Tensor       # (P, 2, 2)
  p_rB: torch.Tensor       # (P, 2, 2)
  p_nmass: torch.Tensor    # (P, 2)
  p_tmass: torch.Tensor    # (P, 2)
  p_bias: torch.Tensor     # (P, 2)
  p_mu: torch.Tensor       # (P,)
  p_imA: torch.Tensor      # (P,)
  p_imB: torch.Tensor
  p_iiA: torch.Tensor
  p_iiB: torch.Tensor
  p_k: torch.Tensor        # (P, 2) raw k11,k22
  p_k12: torch.Tensor      # (P,)
  p_block: torch.Tensor    # (P,) bool


class PostAux(NamedTuple):
  """Pre-solve products the position/sleep stages need."""
  wallm: collision.WallManifold
  pairm: collision.Manifold
  j_state: torch.Tensor
  lc: torch.Tensor


def _presolve(spec: WorldSpec, K: Consts, st: WorldState, motor_speed):
  """Steps 1-5: integrate velocities, narrowphase, warm start; build the
  solver bundle."""
  inv_m, inv_i = body_inv_mass(K, st.is_circle)                 # (B, N)
  lc = local_center(K, st.is_circle)                            # (B, N, 2)

  # ---- 1. integrate velocities + damping ---------------------------------
  v = (st.v + K.dtg) / K.lin_div[:, None]
  w = st.w / K.ang_div

  # ---- 2. narrowphase ------------------------------------------------------
  cos, sin = torch.cos(st.a), torch.sin(st.a)
  geom = collision.make_geom(K, st.is_circle, st.c, cos, sin)
  wallm = collision.collide_wall(geom, K.wall_n, K.wall_off)    # (B, N, W, ...)
  pairm = collision.collide_pair(geom, K.pair_a, K.pair_b)      # (B, P, ...)
  pair_touch = pairm.touch & K.pair_valid[:, None]
  pairm = pairm._replace(touch=pair_touch)

  # ---- 3. warm-start matching ---------------------------------------------
  wc_imp = _match_impulses(wallm.ids, wallm.touch, st.wc_id, st.wc_imp)
  pc_imp = _match_impulses(pairm.ids, pairm.touch, st.pc_id, st.pc_imp)

  # ---- 4. constraint init ---------------------------------------------------
  # wall contacts: static wall is "body A" with zero mass
  w_n = K.wall_n[:, None, :]                                    # (W, 1, 2)
  w_t = perp(w_n)
  w_rB = wallm.points - st.c[:, :, None, None, :]               # (B, N, W, 2, 2)
  w_imB = inv_m[:, :, None, None]
  w_iiB = inv_i[:, :, None, None]
  w_rn = cross_vv(w_rB, w_n)                                    # (B, N, W, 2)
  w_kn = w_imB + w_iiB * (w_rn * w_rn)
  w_rt = cross_vv(w_rB, w_t)
  w_kt = w_imB + w_iiB * (w_rt * w_rt)
  # 2-point block solve (b2ContactSolver::InitializeVelocityConstraints):
  # use the 2x2 K when both points touch and K is well-conditioned, else
  # Box2D degrades the velocity constraint to pointCount=1 (drops point 2)
  w_k12 = w_imB[..., 0] + w_iiB[..., 0] * w_rn[..., 0] * w_rn[..., 1]
  w_det = w_kn[..., 0] * w_kn[..., 1] - w_k12 * w_k12
  w_cond = w_kn[..., 0] * w_kn[..., 0] < 1000.0 * w_det
  w_both = wallm.touch[..., 0] & wallm.touch[..., 1]
  w_block = w_both & w_cond
  w_degrade = w_both & ~w_cond
  w_vtouch = torch.stack([wallm.touch[..., 0],
                          wallm.touch[..., 1] & ~w_degrade], -1)
  wc_imp = torch.where(w_vtouch[..., None], wc_imp, 0.0)
  w_nmass = torch.where(w_vtouch, 1.0 / torch.clamp(w_kn, min=1e-12), 0.0)
  w_tmass = torch.where(w_vtouch, 1.0 / torch.clamp(w_kt, min=1e-12), 0.0)
  # contact friction is the geometric mix with the wall's (Box2D default 0.2)
  w_e = K.w_e[:, None, None]
  w_dv0 = v[:, :, None, None, :] + cross_sv(w[:, :, None, None], w_rB)
  w_vn0 = dot(w_dv0, w_n)
  w_bias = torch.where(w_vn0 < -VELOCITY_THRESHOLD, -w_e * w_vn0, 0.0)

  # pair contacts
  p_a, p_b = K.pair_a, K.pair_b
  p_n = pairm.normal[:, :, None, :]                             # (B, P, 1, 2)
  p_t = perp(p_n)
  p_rA = pairm.points - st.c[:, p_a][:, :, None, :]             # (B, P, 2, 2)
  p_rB = pairm.points - st.c[:, p_b][:, :, None, :]
  p_imA, p_imB = inv_m[:, p_a][..., None], inv_m[:, p_b][..., None]
  p_iiA, p_iiB = inv_i[:, p_a][..., None], inv_i[:, p_b][..., None]
  p_rnA = cross_vv(p_rA, p_n)                                   # (B, P, 2)
  p_rnB = cross_vv(p_rB, p_n)
  p_kn = p_imA + p_imB + p_iiA * (p_rnA * p_rnA) + p_iiB * (p_rnB * p_rnB)
  p_rtA = cross_vv(p_rA, p_t)
  p_rtB = cross_vv(p_rB, p_t)
  p_kt = p_imA + p_imB + p_iiA * (p_rtA * p_rtA) + p_iiB * (p_rtB * p_rtB)
  p_k12 = (p_imA[..., 0] + p_imB[..., 0]
           + p_iiA[..., 0] * p_rnA[..., 0] * p_rnA[..., 1]
           + p_iiB[..., 0] * p_rnB[..., 0] * p_rnB[..., 1])
  p_det = p_kn[..., 0] * p_kn[..., 1] - p_k12 * p_k12
  p_cond = p_kn[..., 0] * p_kn[..., 0] < 1000.0 * p_det
  p_both = pair_touch[..., 0] & pair_touch[..., 1]
  p_block = p_both & p_cond
  p_degrade = p_both & ~p_cond
  p_vtouch = torch.stack([pair_touch[..., 0],
                          pair_touch[..., 1] & ~p_degrade], -1)
  pc_imp = torch.where(p_vtouch[..., None], pc_imp, 0.0)
  p_nmass = torch.where(p_vtouch, 1.0 / torch.clamp(p_kn, min=1e-12), 0.0)
  p_tmass = torch.where(p_vtouch, 1.0 / torch.clamp(p_kt, min=1e-12), 0.0)
  p_dv0 = (v[:, p_b][:, :, None] + cross_sv(w[:, p_b][:, :, None], p_rB)
           - v[:, p_a][:, :, None] - cross_sv(w[:, p_a][:, :, None], p_rA))
  p_vn0 = dot(p_dv0, p_n)
  p_bias = torch.where(p_vn0 < -VELOCITY_THRESHOLD,
                       -K.p_e[:, None] * p_vn0, 0.0)

  # joints
  j_pa, j_ch = K.j_pa, K.j_ch
  j_rA = rot_apply(cos[:, j_pa], sin[:, j_pa], K.j_anchor_a - lc[:, j_pa])
  j_rB = rot_apply(cos[:, j_ch], sin[:, j_ch], K.j_anchor_b - lc[:, j_ch])
  j_mA, j_mB = inv_m[:, j_pa], inv_m[:, j_ch]
  j_iA, j_iB = inv_i[:, j_pa], inv_i[:, j_ch]
  j_axmass_raw = j_iA + j_iB
  j_axmass = torch.where(j_axmass_raw > 0,
                         1.0 / torch.clamp(j_axmass_raw, min=1e-12), 0.0)
  j_axmass = j_axmass * K.j_validf
  j_angle = st.a[:, j_ch] - st.a[:, j_pa] - st.j_ref
  # limit state at init (2.3 semantics); accumulated impulse resets on change.
  # Box2D 2.3's velocity limit-state check uses NO angular slop
  # (b2RevoluteJoint::InitVelocityConstraints); slop applies only in the
  # position correction.
  j_state = torch.where(
      ~(K.j_limited & K.j_valid), 0,
      torch.where(K.j_equal, 3,
                  torch.where(j_angle <= K.j_lower, 1,
                              torch.where(j_angle >= K.j_upper, 2, 0))))
  j_state = j_state.to(torch.int32)
  j_lim_i = torch.where(j_state == st.j_state, st.j_lim, 0.0) * K.j_validf

  # ---- 5. warm start (linear accumulation -> scatter-add) -------------------
  # wall impulses act only on the body
  w_P = wc_imp[..., 0:1] * w_n + wc_imp[..., 1:2] * w_t          # (B, N, W, 2, 2)
  v = v + inv_m[..., None] * w_P.sum(dim=(2, 3))
  w = w + inv_i * cross_vv(w_rB, w_P).sum(dim=(2, 3))
  # pair impulses
  p_P = pc_imp[..., 0:1] * p_n + pc_imp[..., 1:2] * p_t          # (B, P, 2, 2)
  pPsum = p_P.sum(2)                                             # (B, P, 2)
  v.index_add_(1, p_a, -inv_m[:, p_a, None] * pPsum)
  v.index_add_(1, p_b, inv_m[:, p_b, None] * pPsum)
  w.index_add_(1, p_a, -inv_i[:, p_a] * cross_vv(p_rA, p_P).sum(2))
  w.index_add_(1, p_b, inv_i[:, p_b] * cross_vv(p_rB, p_P).sum(2))
  # joints
  j_ax = st.j_mot * K.j_validf + j_lim_i
  jP = st.j_imp * K.j_validf[:, None]
  v.index_add_(1, j_pa, -j_mA[..., None] * jP)
  w.index_add_(1, j_pa, -j_iA * (cross_vv(j_rA, jP) + j_ax))
  v.index_add_(1, j_ch, j_mB[..., None] * jP)
  w.index_add_(1, j_ch, j_iB * (cross_vv(j_rB, jP) + j_ax))

  bundle = SolveBundle(
      v=v, w=w, j_imp=jP, j_mot=st.j_mot * K.j_validf, j_lim=j_lim_i,
      wc=wc_imp, pc=pc_imp, inv_m=inv_m, inv_i=inv_i,
      j_rA=j_rA, j_rB=j_rB, j_axmass=j_axmass, j_state=j_state,
      j_mA=j_mA, j_mB=j_mB, j_iA=j_iA, j_iB=j_iB, motor_speed=motor_speed,
      w_rB=w_rB, w_nmass=w_nmass, w_tmass=w_tmass, w_bias=w_bias,
      w_mu=K.w_mu, w_k=w_kn, w_k12=w_k12, w_block=w_block,
      p_n=pairm.normal, p_rA=p_rA, p_rB=p_rB, p_nmass=p_nmass,
      p_tmass=p_tmass, p_bias=p_bias, p_mu=K.p_mu,
      p_imA=p_imA[..., 0], p_imB=p_imB[..., 0], p_iiA=p_iiA[..., 0],
      p_iiB=p_iiB[..., 0], p_k=p_kn, p_k12=p_k12, p_block=p_block)
  return bundle, PostAux(wallm=wallm, pairm=pairm, j_state=j_state, lc=lc)


def _amax(dm, x):
  """Running per-world max |x| for the convergence exit; x is (B,) or
  (B, ...) and is reduced over its trailing dims."""
  x = torch.abs(x)
  if x.dim() > 1:
    x = x.flatten(1).max(1).values
  return torch.maximum(dm, x)


def _vel_sweep(spec: WorldSpec, b: SolveBundle, carry, track: bool):
  """One full Gauss-Seidel sweep (joints -> walls -> pairs, Box2D island
  order baked into the spec) over the batch, updating `carry`
  (v, w, j_imp, j_mot, j_lim, wc, pc) in place. Returns each world's
  largest |impulse delta| of the sweep when `track`, else None."""
  v, w, j_imp, j_mot, j_lim, wc, pc = carry
  dm = torch.zeros(v.shape[0], device=v.device) if track else None
  K = consts(spec, v.device)

  # ---- joints: motor, then the coupled limit+point solve ----------------
  for j in range(spec.jn):
    pa, ch = int(spec.j_parent[j]), int(spec.j_child[j])
    iA, iB, mA, mB = b.j_iA[:, j], b.j_iB[:, j], b.j_mA[:, j], b.j_mB[:, j]
    rA, rB = b.j_rA[:, j], b.j_rB[:, j]
    # motor (inactive when limits are equal; reference keeps motors enabled
    # on every joint, world_env.py:255-267)
    if not (spec.j_limited[j] and spec.j_lower[j] == spec.j_upper[j]):
      cdot = w[:, ch] - w[:, pa] - b.motor_speed[:, j]
      imp = -b.j_axmass[:, j] * cdot
      cap = float(K.j_cap[j])
      new = torch.clamp(j_mot[:, j] + imp, -cap, cap)
      d = new - j_mot[:, j]
      j_mot[:, j].add_(d)
      w[:, pa].sub_(iA * d)
      w[:, ch].add_(iB * d)
      if track:
        dm = _amax(dm, d)
    state = b.j_state[:, j]
    cdot1 = v[:, ch] + cross_sv(w[:, ch], rB) - v[:, pa] - cross_sv(w[:, pa], rA)
    cdot2 = w[:, ch] - w[:, pa]
    rA0, rA1, rB0, rB1 = rA[:, 0], rA[:, 1], rB[:, 0], rB[:, 1]
    k11 = mA + mB + iA * (rA1 * rA1) + iB * (rB1 * rB1)
    k12 = -iA * rA0 * rA1 - iB * rB0 * rB1
    k13 = -iA * rA1 - iB * rB1
    k22 = mA + mB + iA * (rA0 * rA0) + iB * (rB0 * rB0)
    k23 = iA * rA0 + iB * rB0
    k33 = iA + iB
    dx, dy, dz = _joint_block(state, cdot1[:, 0], cdot1[:, 1], cdot2,
                              j_lim[:, j], k11, k12, k13, k22, k23, k33)
    P = torch.stack([dx, dy], -1)
    j_imp[:, j].add_(P)
    j_lim[:, j].add_(dz)
    v[:, pa].sub_(mA[:, None] * P)
    v[:, ch].add_(mB[:, None] * P)
    w[:, pa].sub_(iA * (cross_vv(rA, P) + dz))
    w[:, ch].add_(iB * (cross_vv(rB, P) + dz))
    if track:
      dm = _amax(_amax(dm, P), dz)

  # ---- walls: parallel over bodies, sequential over walls ------------------
  # per contact, Box2D order: friction for both points, then the normal
  # constraints as a 2x2 block (or sequentially when the block is inactive)
  inv_m, inv_i = b.inv_m, b.inv_i
  inv_m2 = inv_m[..., None]
  for wi in range(len(spec.wall_offset)):
    n = tuple(float(x) for x in spec.wall_normal[wi])
    t = (n[1], -n[0])
    for k in range(2):  # friction, both points
      rB = b.w_rB[:, :, wi, k]                                  # (B, N, 2)
      dv = v + cross_sv(w, rB)
      vt = _dot_c(dv, t)
      lam = -b.w_tmass[:, :, wi, k] * vt
      maxf = b.w_mu * wc[:, :, wi, k, 0]
      old = wc[:, :, wi, k, 1]
      new = torch.clamp(old + lam, -maxf, maxf)
      d = new - old
      old.copy_(new)
      P = _times_c(d, t)
      v.add_(inv_m2 * P)
      w.add_(inv_i * cross_vv(rB, P))
      if track:
        dm = _amax(dm, d)
    # normal: sequential candidate deltas (applied virtually in order)
    rB1, rB2 = b.w_rB[:, :, wi, 0], b.w_rB[:, :, wi, 1]
    a1, a2 = wc[:, :, wi, 0, 0], wc[:, :, wi, 1, 0]
    vs, ws = v, w
    d_seq = []
    for k, (rB, acc) in enumerate(((rB1, a1), (rB2, a2))):
      dv = vs + cross_sv(ws, rB)
      vn = _dot_c(dv, n)
      lam = -b.w_nmass[:, :, wi, k] * (vn - b.w_bias[:, :, wi, k])
      dk = torch.clamp(acc + lam, min=0.0) - acc
      d_seq.append(dk)
      if k == 0:
        P = _times_c(dk, n)
        vs = vs + inv_m2 * P
        ws = ws + inv_i * cross_vv(rB, P)
    # block candidate (2x2 LCP, b2ContactSolver case enumeration)
    vn1 = _dot_c(v + cross_sv(w, rB1), n)
    vn2 = _dot_c(v + cross_sv(w, rB2), n)
    d1b, d2b = _block_lcp(
        vn1 - b.w_bias[:, :, wi, 0], vn2 - b.w_bias[:, :, wi, 1], a1, a2,
        b.w_k[:, :, wi, 0], b.w_k[:, :, wi, 1], b.w_k12[:, :, wi],
        b.w_nmass[:, :, wi, 0], b.w_nmass[:, :, wi, 1])
    blk = b.w_block[:, :, wi]
    d1 = torch.where(blk, d1b, d_seq[0])
    d2 = torch.where(blk, d2b, d_seq[1])
    v.add_(inv_m2 * _times_c(d1 + d2, n))
    w.add_(inv_i * (cross_vv(rB1, _times_c(d1, n))
                    + cross_vv(rB2, _times_c(d2, n))))
    a1.add_(d1)
    a2.add_(d2)
    if track:
      dm = _amax(_amax(dm, d1), d2)

  # ---- body-body pairs ---------------------------------------------------------
  for p in range(len(spec.pair_a)):
    if not spec.pair_valid[p]:
      continue
    a, bb = int(spec.pair_a[p]), int(spec.pair_b[p])
    n = b.p_n[:, p]
    t = perp(n)
    imA, imB = b.p_imA[:, p, None], b.p_imB[:, p, None]
    iA, iB = b.p_iiA[:, p], b.p_iiB[:, p]
    for k in range(2):
      rA, rB = b.p_rA[:, p, k], b.p_rB[:, p, k]
      dv = v[:, bb] + cross_sv(w[:, bb], rB) - v[:, a] - cross_sv(w[:, a], rA)
      vt = dot(dv, t)
      lam = -b.p_tmass[:, p, k] * vt
      maxf = b.p_mu[p] * pc[:, p, k, 0]
      old = pc[:, p, k, 1]
      new = torch.clamp(old + lam, -maxf, maxf)
      d = new - old
      old.copy_(new)
      P = d[:, None] * t
      v[:, a].sub_(imA * P)
      v[:, bb].add_(imB * P)
      w[:, a].sub_(iA * cross_vv(rA, P))
      w[:, bb].add_(iB * cross_vv(rB, P))
      if track:
        dm = _amax(dm, d)
    # normal: sequential candidate deltas from the post-friction state
    rA1, rB1 = b.p_rA[:, p, 0], b.p_rB[:, p, 0]
    rA2, rB2 = b.p_rA[:, p, 1], b.p_rB[:, p, 1]
    a1, a2 = pc[:, p, 0, 0], pc[:, p, 1, 0]
    vsa, vsb, wsa, wsb = v[:, a], v[:, bb], w[:, a], w[:, bb]
    d_seq = []
    for k, (rA, rB, acc) in enumerate(((rA1, rB1, a1), (rA2, rB2, a2))):
      dv = vsb + cross_sv(wsb, rB) - vsa - cross_sv(wsa, rA)
      vn = dot(dv, n)
      lam = -b.p_nmass[:, p, k] * (vn - b.p_bias[:, p, k])
      dk = torch.clamp(acc + lam, min=0.0) - acc
      d_seq.append(dk)
      if k == 0:
        P = dk[:, None] * n
        vsa = vsa - imA * P
        vsb = vsb + imB * P
        wsa = wsa - iA * cross_vv(rA, P)
        wsb = wsb + iB * cross_vv(rB, P)
    # block candidate from the same pre-normal state
    dv1 = v[:, bb] + cross_sv(w[:, bb], rB1) - v[:, a] - cross_sv(w[:, a], rA1)
    dv2 = v[:, bb] + cross_sv(w[:, bb], rB2) - v[:, a] - cross_sv(w[:, a], rA2)
    d1b, d2b = _block_lcp(
        dot(dv1, n) - b.p_bias[:, p, 0], dot(dv2, n) - b.p_bias[:, p, 1],
        a1, a2, b.p_k[:, p, 0], b.p_k[:, p, 1], b.p_k12[:, p],
        b.p_nmass[:, p, 0], b.p_nmass[:, p, 1])
    blk = b.p_block[:, p]
    d1 = torch.where(blk, d1b, d_seq[0])
    d2 = torch.where(blk, d2b, d_seq[1])
    P = (d1 + d2)[:, None] * n
    v[:, a].sub_(imA * P)
    v[:, bb].add_(imB * P)
    n1, n2 = d1[:, None] * n, d2[:, None] * n
    dw = cross_vv(rA1, n1) + cross_vv(rA2, n2)
    dwB = cross_vv(rB1, n1) + cross_vv(rB2, n2)
    w[:, a].sub_(iA * dw)
    w[:, bb].add_(iB * dwB)
    a1.add_(d1)
    a2.add_(d2)
    if track:
      dm = _amax(_amax(dm, d1), d2)
  return dm


def velocity_solve(spec: WorldSpec, b: SolveBundle) -> SolveBundle:
  """Sequential-impulse velocity iterations for the batch (plain path)."""
  carry = [x.clone() for x in (b.v, b.w, b.j_imp, b.j_mot, b.j_lim, b.wc, b.pc)]
  tol = float(spec.solver_exit_tol)
  if tol > 0.0:
    # convergence exit: each world stops once an iteration's largest impulse
    # delta is below tol, and its carry stays frozen from then on (what
    # boxlcd_tpu's while_loop does under vmap); the batch runs while any
    # world is still active
    dm = torch.full((b.v.shape[0],), float('inf'), device=b.v.device)
    for _ in range(spec.vel_iters):
      active = dm > tol
      if not bool(active.any()):
        break
      new = [x.clone() for x in carry]
      new_dm = _vel_sweep(spec, b, new, track=True)
      carry = [_sel(active, x, o) for x, o in zip(new, carry)]
      dm = torch.where(active, new_dm, dm)
  else:
    for _ in range(spec.vel_iters):
      _vel_sweep(spec, b, carry, track=False)
  v, w, j_imp, j_mot, j_lim, wc, pc = carry
  return b._replace(v=v, w=w, j_imp=j_imp, j_mot=j_mot, j_lim=j_lim,
                    wc=wc, pc=pc)


def _position_solve(spec: WorldSpec, st: WorldState, b: SolveBundle,
                    aux: PostAux, record_done=False, ran=None):
  """Steps 7-8: integrate positions + NGS corrections. Returns (c, a); with
  record_done, (c, a, dones) where dones (B, pos_iters) is each world's
  Box2D exit flag after each iteration (research/scripts/exit_probe.py),
  and every iteration runs. `ran`, a (B,) int64 tensor, takes each world's
  count of the iterations its result comes from: up to and including the
  one that met the exit (the megakernel's count).

  b2Island::Solve EXITS the position loop once the iteration's contact
  minSeparation >= -3*linearSlop AND every joint reports
  positionError <= linearSlop && angularError <= angularSlop, so the loop
  rarely runs all pos_iters. Replicated per world with a `done` mask (the
  qualifying iteration's corrections are still applied); with
  solver_exit_tol > 0 the batch also stops once every world is done, which
  gives the same result since later trips are reverted for done worlds."""
  dt = spec.dt
  wallm, pairm, j_state, lc = aux.wallm, aux.pairm, aux.j_state, aux.lc
  inv_m, inv_i = b.inv_m, b.inv_i
  inv_m2 = inv_m[..., None]
  nw = len(spec.wall_offset)
  early_exit = float(spec.solver_exit_tol) > 0.0
  K = consts(spec, st.c.device)

  # ---- 7. integrate positions --------------------------------------------------
  c = st.c + dt * b.v
  a = st.a + dt * b.w
  done = torch.zeros(c.shape[0], dtype=torch.bool, device=c.device)
  dones = []

  # ---- 8. position iterations (NGS) ---------------------------------------------
  # Box2D island order per position iteration: contacts first (walls then
  # pairs, spec order), then joints (limit correction, then point)
  for _ in range(spec.pos_iters):
    if ran is not None:
      ran += ~done
    c0, a0 = c, a
    c, a = c.clone(), a.clone()
    minsep = torch.zeros(c.shape[0], device=c.device)

    # wall contacts (parallel over bodies, sequential over W*2 slots)
    for idx in range(nw * 2):
      wi, k = idx // 2, idx % 2
      n = tuple(float(x) for x in spec.wall_normal[wi])
      touch = wallm.touch[:, :, wi, k]
      pt = c + rot_apply(torch.cos(a), torch.sin(a), wallm.lps[:, :, wi, k])
      sep = _dot_c(pt, n) - float(spec.wall_offset[wi]) \
          - wallm.rad_sub[:, :, wi]
      minsep = torch.minimum(
          minsep, torch.where(touch, sep, 0.0).min(-1).values)
      C = torch.clamp(BAUMGARTE * (sep + LINEAR_SLOP),
                      -MAX_LINEAR_CORRECTION, 0.0)
      rB = pt - c
      rn = rB[..., 0] * n[1] - rB[..., 1] * n[0]
      kn = inv_m + inv_i * (rn * rn)
      imp = torch.where(touch, -C / torch.clamp(kn, min=1e-12), 0.0)
      P = _times_c(imp, n)
      c = c + inv_m2 * P
      a = a + inv_i * cross_vv(rB, P)

    # pair contacts
    for idx in range(len(spec.pair_a) * 2):
      p, k = idx // 2, idx % 2
      if not spec.pair_valid[p]:
        continue
      ia, ib = int(spec.pair_a[p]), int(spec.pair_b[p])
      touch = pairm.touch[:, p, k]
      cosA, sinA = torch.cos(a[:, ia]), torch.sin(a[:, ia])
      cosB, sinB = torch.cos(a[:, ib]), torch.sin(a[:, ib])
      mt = pairm.mtype[:, p]
      rad = pairm.rad_sub[:, p]
      ln, lpp = pairm.ln[:, p], pairm.lpp[:, p]
      # circles
      pA0 = c[:, ia]
      pB0 = c[:, ib] + rot_apply(cosB, sinB, pairm.lps[:, p, 0])
      d0 = pB0 - pA0
      dist0 = norm(d0)
      up = torch.zeros_like(d0)
      up[:, 1] = 1.0
      n0 = _sel(dist0 > 1e-9, d0 / torch.clamp(dist0, min=1e-9)[:, None], up)
      sep0 = dist0 - rad
      pt0 = 0.5 * (pA0 + pB0)
      # faceA
      nf1 = rot_apply(cosA, sinA, ln)
      plane1 = c[:, ia] + rot_apply(cosA, sinA, lpp)
      clip1 = c[:, ib] + rot_apply(cosB, sinB, pairm.lps[:, p, k])
      sep1 = dot(clip1 - plane1, nf1) - rad
      # faceB
      nf2 = rot_apply(cosB, sinB, ln)
      plane2 = c[:, ib] + rot_apply(cosB, sinB, lpp)
      clip2 = c[:, ia] + rot_apply(cosA, sinA, pairm.lps[:, p, k])
      sep2 = dot(clip2 - plane2, nf2) - rad

      n = _sel(mt == 0, n0, _sel(mt == 1, nf1, -nf2))
      pt = _sel(mt == 0, pt0, _sel(mt == 1, clip1, clip2))
      sep = torch.where(mt == 0, sep0, torch.where(mt == 1, sep1, sep2))

      minsep = torch.minimum(minsep, torch.where(touch, sep, 0.0))
      C = torch.clamp(BAUMGARTE * (sep + LINEAR_SLOP),
                      -MAX_LINEAR_CORRECTION, 0.0)
      rA = pt - c[:, ia]
      rB = pt - c[:, ib]
      rnA, rnB = cross_vv(rA, n), cross_vv(rB, n)
      kn = (inv_m[:, ia] + inv_m[:, ib] + inv_i[:, ia] * (rnA * rnA)
            + inv_i[:, ib] * (rnB * rnB))
      imp = torch.where(touch, -C / torch.clamp(kn, min=1e-12), 0.0)
      P = imp[:, None] * n
      c[:, ia].sub_(inv_m[:, ia, None] * P)
      c[:, ib].add_(inv_m[:, ib, None] * P)
      a[:, ia].sub_(inv_i[:, ia] * cross_vv(rA, P))
      a[:, ib].add_(inv_i[:, ib] * cross_vv(rB, P))

    # joints: limit correction then point correction (Box2D order)
    jbad = torch.zeros_like(done)
    for j in range(spec.jn):
      pa, ch = int(spec.j_parent[j]), int(spec.j_child[j])
      iA, iB, mA, mB = b.j_iA[:, j], b.j_iB[:, j], b.j_mA[:, j], b.j_mB[:, j]
      state = j_state[:, j]
      ang = a[:, ch] - a[:, pa] - st.j_ref[:, j]
      lo, hi = float(spec.j_lower[j]), float(spec.j_upper[j])
      c_eq = torch.clamp(ang - lo, -MAX_ANGULAR_CORRECTION,
                         MAX_ANGULAR_CORRECTION)
      c_lo = torch.clamp(ang - lo + ANGULAR_SLOP, -MAX_ANGULAR_CORRECTION, 0.0)
      c_hi = torch.clamp(ang - hi - ANGULAR_SLOP, 0.0, MAX_ANGULAR_CORRECTION)
      C = torch.where(state == 3, c_eq,
                      torch.where(state == 1, c_lo,
                                  torch.where(state == 2, c_hi, 0.0)))
      # b2RevoluteJoint angularError: |C| at equal limits, violation depth at
      # a one-sided limit, 0 when inactive
      ang_err = torch.where(state == 3, torch.abs(c_eq),
                            torch.where(state == 1, lo - ang,
                                        torch.where(state == 2, ang - hi, 0.0)))
      d = -b.j_axmass[:, j] * C
      a[:, pa].sub_(iA * d)
      a[:, ch].add_(iB * d)
      # point
      rA = rot_apply(torch.cos(a[:, pa]), torch.sin(a[:, pa]),
                     K.j_anchor_a[j] - lc[:, pa])
      rB = rot_apply(torch.cos(a[:, ch]), torch.sin(a[:, ch]),
                     K.j_anchor_b[j] - lc[:, ch])
      Cv = c[:, ch] + rB - c[:, pa] - rA
      pos_err = norm(Cv)
      rA0, rA1, rB0, rB1 = rA[:, 0], rA[:, 1], rB[:, 0], rB[:, 1]
      k11 = mA + mB + iA * (rA1 * rA1) + iB * (rB1 * rB1)
      k12 = -iA * rA0 * rA1 - iB * rB0 * rB1
      k22 = mA + mB + iA * (rA0 * rA0) + iB * (rB0 * rB0)
      det = k11 * k22 - k12 * k12
      det = torch.where(torch.abs(det) > 1e-12, det, 1.0)
      P = -torch.stack([k22 * Cv[:, 0] - k12 * Cv[:, 1],
                        k11 * Cv[:, 1] - k12 * Cv[:, 0]], -1) / det[:, None]
      c[:, pa].sub_(mA[:, None] * P)
      c[:, ch].add_(mB[:, None] * P)
      a[:, pa].sub_(iA * cross_vv(rA, P))
      a[:, ch].add_(iB * cross_vv(rB, P))
      jbad = jbad | (pos_err > LINEAR_SLOP) | (ang_err > ANGULAR_SLOP)

    okay = (minsep >= -3.0 * LINEAR_SLOP) & ~jbad
    c = _sel(done, c0, c)
    a = _sel(done, a0, a)
    done = done | okay
    if record_done:
      dones.append(done)
    elif early_exit and bool(done.all()):
      break
  if record_done:
    return c, a, torch.stack(dones, 1)
  return c, a


def _finalize(spec: WorldSpec, K: Consts, st: WorldState, b: SolveBundle,
              aux: PostAux, motor_changed, c, a) -> WorldState:
  """Steps 9-10: sleeping + state writeback."""
  wallm, pairm = aux.wallm, aux.pairm
  v, w = b.v, b.w

  # ---- 9. sleeping (island-based, Box2D semantics) --------------------------
  sleep_time = st.sleep_time
  if spec.allow_sleep:
    n = spec.n
    B = c.shape[0]
    # adjacency: joints + touching pair contacts (walls are static)
    adj = K.adj_joint.expand(B, n, n).clone()
    pair_touching = pairm.touch.any(-1)                          # (B, P)
    bidx = torch.arange(B, device=c.device)[:, None]
    adj[bidx, K.pair_a[None], K.pair_b[None]] |= pair_touching
    adj[bidx, K.pair_b[None], K.pair_a[None]] |= pair_touching
    # islands via min-label propagation
    label = K.body_ids.expand(B, n)
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2))))) + 1):
      neigh = torch.where(adj, label[:, None, :], n)
      label = torch.minimum(label, neigh.min(-1).values)
    # per-body slow test + forced wake from motor-speed changes
    slow = (((v * v).sum(-1) <= LIN_SLEEP_TOL_SQ)
            & (w * w <= ANG_SLEEP_TOL_SQ))
    forced = torch.zeros_like(slow)
    for j in range(spec.jn):
      mc = motor_changed[:, j]
      forced[:, int(spec.j_parent[j])] |= mc
      forced[:, int(spec.j_child[j])] |= mc
    sleep_time = torch.where(slow & ~forced, st.sleep_time + spec.dt, 0.0)
    same = label[:, :, None] == label[:, None, :]
    isl_min = torch.where(same, sleep_time[:, None, :],
                          float('inf')).min(-1).values
    asleep = isl_min >= TIME_TO_SLEEP
    v = torch.where(asleep[..., None], 0.0, v)
    w = torch.where(asleep, 0.0, w)
    c = torch.where(asleep[..., None], st.c, c)
    a = torch.where(asleep, st.a, a)

  # ---- 10. write back ------------------------------------------------------------
  return st._replace(
      c=c, a=a, v=v, w=w, sleep_time=sleep_time,
      wc_imp=torch.where(wallm.touch[..., None], b.wc, 0.0),
      wc_id=torch.where(wallm.touch, wallm.ids, -1),
      pc_imp=torch.where(pairm.touch[..., None], b.pc, 0.0),
      pc_id=torch.where(pairm.touch, pairm.ids, -1),
      j_imp=b.j_imp, j_mot=b.j_mot, j_lim=b.j_lim, j_state=aux.j_state)


def motor_speeds(spec: WorldSpec, actions):
  """(..., act_size) actions -> (..., J) motor speeds.

  Action semantics follow the reference (boxLCD/world_env.py:434-444):
  speed control sets motor speed to gain * clip(action, -1, 1) with fixed max
  torque. Joints with equal limits are locked and take no action."""
  K = consts(spec, actions.device)
  act = torch.clamp(actions, -1.0, 1.0)
  return K.j_speed * (act[..., K.a_idx] * K.has_act)


def step_world_motor(spec: WorldSpec, states: WorldState, motor_speed,
                     velocity_solver=None, substep_solver=None,
                     counts=None) -> WorldState:
  """Advance every world one env step = spec.substeps physics substeps, at
  the given motor speeds (B, J).

  The solver stages run on the whole batch, so a fused kernel
  (engine/cuda_solver.py) can take their place, as in boxlcd_tpu's
  step_world_batch: `substep_solver(states, bundle, aux)` replaces the
  velocity iterations, the position integration and the NGS position
  iterations and returns `(bundle', c, a)`; `velocity_solver(bundle)`
  replaces only the velocity iterations. With neither, the plain stages
  run.

  Where the plain NGS runs, `counts` (B, 2) int64 takes each world's NGS
  iterations (_position_solve's `ran`) and substeps (COUNTS); while tracing
  is on it defaults to the tracer's buffer."""
  if counts is None and substep_solver is None:
    counts = trace.world_counts(COUNTS, states.c.shape[0], states.c.device)
  K = consts(spec, states.c.device)
  # a changed motor speed wakes the joint's bodies (pybox2d SetMotorSpeed)
  motor_changed = (motor_speed != states.prev_motor) & K.j_valid
  for _ in range(spec.substeps):
    bundle, aux = _presolve(spec, K, states, motor_speed)
    if substep_solver is not None:
      bundle, c, a = substep_solver(states, bundle, aux)
    else:
      if velocity_solver is None:
        bundle = velocity_solve(spec, bundle)
      else:
        bundle = velocity_solver(bundle)
      c, a = _position_solve(spec, states, bundle, aux,
                             ran=None if counts is None else counts[:, 0])
      if counts is not None:
        counts[:, 1] += 1
    states = _finalize(spec, K, states, bundle, aux, motor_changed, c, a)
  return states._replace(ep_t=states.ep_t + 1, prev_motor=motor_speed)


def step_world_batch(spec: WorldSpec, states: WorldState, actions,
                     velocity_solver=None, substep_solver=None) -> WorldState:
  """Advance every world one env step; actions: (B, act_size), mapped to
  motor speeds by motor_speeds. The solver hooks are step_world_motor's."""
  return step_world_motor(spec, states, motor_speeds(spec, actions),
                          velocity_solver, substep_solver)


def step_world(spec: WorldSpec, state: WorldState, action) -> WorldState:
  """One world (no worlds axis) one env step: a batch of 1."""
  out = step_world_batch(
      spec, WorldState(*(x[None] for x in state)), action[None])
  return WorldState(*(x[0] for x in out))
