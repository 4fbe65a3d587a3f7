"""Compile a declarative WorldDef into fixed-shape struct-of-arrays constants.

This is the static half of the engine: everything shape-affecting (body
counts, joint topology, collision-pair lists, observation/action layouts,
reset sampling tables) is resolved here on the host into numpy arrays. The
dynamic half (engine/physics.py) reads a WorldSpec with no data-dependent
shapes.

Semantics compiled here mirror the reference env construction
(reference: boxLCD/world_env.py:69-142 obs/act spec, :197-304 body creation,
:309-316 walls) and Box2D fixture/body defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from portbench.reference import rutils as utils
from portbench.reference import geom
from portbench.reference.world_defs import ROBOT_FILLER, ShapeSpec, WorldDef

# Default solver iterations when G does not set vel_iters/pos_iters: the
# reference runs Box2D at Step(dt, 180, 60) (boxLCD/world_env.py:446-452).
DEFAULT_ITERS = (180, 60)

# shape flags
CIRCLE, POLY, RANDOM = 0, 1, 2
# obs-kind enum: absolute features, then root-relative variants
KX, KY, KCOS, KSIN = 0, 1, 2, 3
KX_REL, KY_REL, KCOS_REL, KSIN_REL = 4, 5, 6, 7
# body roles for reset
ROLE_ROOT, ROLE_CHILD, ROLE_OBJECT = 0, 1, 2

WALL_FRICTION = 0.2      # Box2D default fixture friction for the static walls
WALL_RESTITUTION = 0.0


def _f(x):
  return np.asarray(x, dtype=np.float32)


def _i(x):
  return np.asarray(x, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class WorldSpec:
  """Static world description as numpy constants (copied to the device by
  the physics and raster modules)."""
  # --- bodies (creation order: per robot [root, joints...], then objects) ---
  n: int
  names: tuple                      # body names ('urchin0:root', 'object0', ...)
  shape_static: np.ndarray          # (N,) CIRCLE | POLY | RANDOM
  radius: np.ndarray                # (N,) circle-variant radius
  verts: np.ndarray                 # (N, MAX_VERTS, 2) polygon-variant vertices (CCW)
  nverts: np.ndarray                # (N,)
  normals: np.ndarray               # (N, MAX_VERTS, 2) outward edge normals
  draw_verts: np.ndarray            # (N, MAX_VERTS, 2) verts in b2 draw order
  inv_m: np.ndarray                 # (N, 2) inverse mass [circle-variant, poly-variant]
  inv_i: np.ndarray                 # (N, 2) inverse rotational inertia per variant
  local_center: np.ndarray          # (N, 2, 2) local center of mass per variant
  friction: np.ndarray              # (N,)
  restitution: np.ndarray           # (N,)
  lin_damp: np.ndarray              # (N,)
  ang_damp: np.ndarray              # (N,)
  # --- joints (revolute), padded to >=1 with a disabled slot ---
  jn: int                           # true joint count
  j_parent: np.ndarray              # (J,)
  j_child: np.ndarray               # (J,)
  j_anchor_a: np.ndarray            # (J, 2) local anchor on parent (body origin frame)
  j_anchor_b: np.ndarray            # (J, 2)
  j_lower: np.ndarray               # (J,)
  j_upper: np.ndarray               # (J,)
  j_limited: np.ndarray             # (J,) bool
  j_speed: np.ndarray               # (J,) motor speed gain
  j_torque: np.ndarray              # (J,) max motor torque
  j_act: np.ndarray                 # (J,) action index or -1
  j_valid: np.ndarray               # (J,) bool (False for the padding slot)
  j_order: np.ndarray               # (J,) creation index of slot j (slots are
                                    # stored in Box2D island solve order)
  j_angle0: np.ndarray              # (J,) spawn angle offset from root angle
  # --- collision pairs (filter- and joint-aware), padded to >=1 ---
  pair_a: np.ndarray                # (P,)
  pair_b: np.ndarray                # (P,)
  pair_valid: np.ndarray            # (P,) bool
  # --- walls as inward half-planes: separation(p) = normal.p - offset ---
  wall_normal: np.ndarray           # (W, 2)
  wall_offset: np.ndarray           # (W,)
  # --- sim params ---
  gravity: np.ndarray               # (2,)
  dt: float                         # substep timestep
  substeps: int
  vel_iters: int
  pos_iters: int
  width: float                      # world width (x in [0, width])
  height: float
  # --- reset sampling tables ---
  role: np.ndarray                  # (N,) ROLE_*
  root_of: np.ndarray               # (N,) index of owning robot root (or self)
  parent_of: np.ndarray             # (N,) parent body index (children), else self
  rs_rangex: np.ndarray             # (N,) spawn range scale for x
  rs_rangey_lo: np.ndarray          # (N,)
  rs_rangey_hi: np.ndarray          # (N,)
  rs_rand_angle: np.ndarray         # (N,) bool
  # --- obs/act layout ---
  obs_keys: tuple
  obs_bounds: np.ndarray            # (K, 2) lo/hi
  obs_body: np.ndarray              # (K,) source body index
  obs_kind: np.ndarray              # (K,) KX|KY|KCOS|KSIN
  pobs_idxs: np.ndarray             # indices of proprio keys within obs vector
  pobs_keys: tuple
  act_keys: tuple
  # teleport tables: per body, obs indices of its x/y/cos/sin entries
  b_xi: np.ndarray                  # (N,)
  b_yi: np.ndarray
  b_ci: np.ndarray
  b_si: np.ndarray
  allow_sleep: bool = True          # Box2D b2World default
  # solver convergence exit: when > 0, the velocity Gauss-Seidel loop stops
  # once the largest impulse delta of an iteration drops below this (N*s),
  # and the NGS loop exits at Box2D's own done condition instead of masking
  # remaining trips. 0.0 (default) = exact fixed trip counts. The NGS exit
  # is semantically exact (b2Island::Solve breaks there); the velocity exit
  # deviates by O(tol * inv_m * dt) per substep — far under LINEAR_SLOP at
  # the 1e-4 bench setting (parity-floor-tested in tests/test_parity.py).
  solver_exit_tol: float = 0.0

  @property
  def obs_size(self):
    return len(self.obs_keys)

  @property
  def act_size(self):
    return max(1, len(self.act_keys))

  @property
  def pobs_size(self):
    return len(self.pobs_idxs)


def _shape_tables(shape: ShapeSpec, kind_flag: int, size: float):
  """Return (radius, verts, nverts, normals, draw_verts) for both variants.

  `draw_verts` carries the vertex order pybox2d's `shape.vertices` reports —
  SetAsBox order for box= fixtures, b2PolygonShape::Set gift-wrap order for
  explicit vertex lists — which the exact rasterizer must traverse
  (reference draws `trans * v for v in shape.vertices`, world_env.py:501-505).
  """
  if kind_flag == RANDOM:
    # union: circle of `size` OR box of half-extent `size`
    # (reference: boxLCD/world_env.py:273-274); box variant is a box= fixture
    radius = size
    draw = np.array(
        [(-size, -size), (size, -size), (size, size), (-size, size)])
    hull = geom.convex_hull_ccw(draw)
  elif shape.kind == 'circle':
    radius = shape.radius
    r = shape.radius
    draw = np.array([(-r, -r), (r, -r), (r, r), (-r, r)])
    hull = geom.convex_hull_ccw(draw)
  else:
    radius = max(abs(np.asarray(shape.verts)).max(), 1e-3)
    draw = (np.asarray(shape.verts, dtype=np.float64) if shape.box
            else geom.b2_set_order(np.array(shape.verts)))
    hull = geom.convex_hull_ccw(np.array(shape.verts))
  verts, nv = geom.pad_verts(hull)
  draw_verts, dnv = geom.pad_verts(draw)
  assert dnv == nv, f'draw/hull vertex count mismatch: {dnv} vs {nv}'
  normals = np.zeros_like(verts)
  normals[:nv] = geom.poly_normals(hull)
  return radius, verts, nv, normals, draw_verts


def compile_world(world_def: WorldDef, G: utils.AttrDict) -> WorldSpec:
  """Expand robots, lay out bodies/joints/pairs/walls, build obs/act tables."""
  # all_corners and compact_obs are broken in the reference itself
  # (ipdb stub at world_env.py:178; ':angle' keys missing from obs_info) —
  # explicitly unsupported here
  assert not G.get('all_corners', 0) and not G.get('compact_obs', 0), \
      'all_corners/compact_obs are non-functional in the reference; unsupported'
  root_offset = int(G.get('root_offset', 0))
  angular_offset = int(G.get('angular_offset', 0))

  width = float(int(G.wh_ratio * G.base_dim))
  height = float(G.base_dim)

  robots = [ROBOT_FILLER[r.type](r, G) for r in world_def.robots]
  objects = list(world_def.objects)

  # ---- bodies -------------------------------------------------------------
  names: List[str] = []
  shape_static, radius, verts, nverts, normals = [], [], [], [], []
  draw_verts = []
  inv_m, inv_i, local_center = [], [], []
  friction, restitution, lin_damp, ang_damp = [], [], [], []
  category, mask = [], []
  role, root_of, parent_of = [], [], []
  rs_rangex, rs_rangey_lo, rs_rangey_hi, rs_rand_angle = [], [], [], []
  j_rows = []  # (parent_name, child_name, joint)

  def add_body(name, shape, kind_flag, size, density, fric, rest, cat, msk,
               ldamp, adamp, b_role, b_root, b_parent,
               rangex=0.0, ry_lo=0.0, ry_hi=0.0, rand_ang=False):
    rad, vv, nv, nn, dv = _shape_tables(shape, kind_flag, size)
    mc, ic, cc = geom.circle_mass(rad, density)
    mp, ip, cp = geom.poly_mass(vv[:nv], density)
    # Box2D clamps zero-mass dynamic bodies to mass 1 (b2Body::ResetMassData)
    names.append(name)
    shape_static.append(kind_flag)
    radius.append(rad)
    verts.append(vv)
    nverts.append(nv)
    normals.append(nn)
    draw_verts.append(dv)
    inv_m.append([1.0 / mc, 1.0 / mp])
    inv_i.append([1.0 / ic if ic > 0 else 0.0, 1.0 / ip if ip > 0 else 0.0])
    local_center.append([cc, cp])
    friction.append(fric)
    restitution.append(rest)
    lin_damp.append(ldamp)
    ang_damp.append(adamp)
    category.append(cat)
    mask.append(msk)
    role.append(b_role)
    root_of.append(b_root)
    parent_of.append(b_parent)
    rs_rangex.append(rangex)
    rs_rangey_lo.append(ry_lo)
    rs_rangey_hi.append(ry_hi)
    rs_rand_angle.append(rand_ang)
    return len(names) - 1

  name2idx: Dict[str, int] = {}
  for robot in robots:
    rb = robot.root_body
    rngx = 1 - (2 * robot.bound / width)
    rngy = 1 - (2 * robot.bound / height)
    # root spawns at fixed height -rngy (reference: boxLCD/world_env.py:207)
    root_name = f'{robot.name}:root'
    # root fixture: density from def (or 1), friction 1.0 hardcoded
    # (reference: boxLCD/world_env.py:203)
    ridx = add_body(root_name, rb.shape,
                    CIRCLE if rb.shape.kind == 'circle' else POLY,
                    rb.shape.radius,
                    rb.density if rb.density is not None else 1.0,
                    1.0, 0.0, rb.categoryBits, rb.maskBits,
                    robot.linearDamping, robot.angularDamping,
                    ROLE_ROOT, -1, -1,
                    rangex=rngx, ry_lo=-rngy, ry_hi=-rngy,
                    rand_ang=bool(robot.rand_angle))
    root_of[ridx] = ridx
    parent_of[ridx] = ridx
    name2idx[root_name] = ridx
    # joint bodies in joint-dict order; fixture density=1, restitution=0
    # (reference: boxLCD/world_env.py:238)
    for bj_name, joint in robot.joints.items():
      body = robot.bodies[bj_name]
      bname = f'{robot.name}:{bj_name}'
      pname = f'{robot.name}:{joint.parent}'
      bidx = add_body(bname, body.shape, POLY, 0.0, 1.0,
                      body.friction, 0.0, body.categoryBits, body.maskBits,
                      0.0, 0.0, ROLE_CHILD, ridx, name2idx[pname])
      name2idx[bname] = bidx
      j_rows.append((pname, bname, joint))

  has_robots = len(robots) > 0
  for obj in objects:
    kind_flag = {'circle': CIRCLE, 'box': POLY, 'random': RANDOM}[obj.shape]
    shape = (ShapeSpec('circle', radius=obj.size) if obj.shape == 'circle'
             else ShapeSpec('polygon', verts=(
                 (-obj.size, -obj.size), (obj.size, -obj.size),
                 (obj.size, obj.size), (-obj.size, obj.size)), box=True))
    rngx = 1 - (2 * obj.size / width)
    rngy = 1 - (2 * obj.size / height)
    # objects spawn lower when robots present (reference: world_env.py:282-285)
    ry_hi = -0.25 if has_robots else rngy
    oidx = add_body(obj.name, shape, kind_flag, obj.size, obj.density,
                    obj.friction, obj.restitution, obj.categoryBits, 0xFFFF,
                    obj.linearDamping, obj.angularDamping,
                    ROLE_OBJECT, -1, -1,
                    rangex=rngx, ry_lo=-rngy, ry_hi=ry_hi,
                    rand_ang=bool(obj.rand_angle))
    root_of[oidx] = oidx
    parent_of[oidx] = oidx
    name2idx[obj.name] = oidx

  n = len(names)

  # ---- joints -------------------------------------------------------------
  j_parent, j_child = [], []
  j_anchor_a, j_anchor_b, j_lower, j_upper = [], [], [], []
  j_limited, j_speed, j_torque, j_angle0 = [], [], [], []
  joint_names = []
  for pname, cname, joint in j_rows:
    j_parent.append(name2idx[pname])
    j_child.append(name2idx[cname])
    j_anchor_a.append(joint.anchorA)
    j_anchor_b.append(joint.anchorB)
    j_lower.append(joint.limits[0])
    j_upper.append(joint.limits[1])
    j_limited.append(joint.limited)
    j_speed.append(joint.speed)
    j_torque.append(joint.torque)
    j_angle0.append(joint.angle)
    joint_names.append(cname)
  jn = len(j_rows)
  if jn == 0:  # pad a disabled slot so scan shapes stay non-empty
    j_parent, j_child = [0], [0]
    j_anchor_a, j_anchor_b = [(0.0, 0.0)], [(0.0, 0.0)]
    j_lower, j_upper, j_limited = [0.0], [0.0], [False]
    j_speed, j_torque, j_angle0 = [0.0], [0.0], [0.0]
  j_valid = np.arange(len(j_parent)) < jn

  # ---- Box2D island joint order --------------------------------------------
  # b2World::Solve builds each island by DFS from the most recently created
  # body (b2World's body list is prepended on creation), walking each body's
  # joint-edge list, which is likewise prepended when the joint is created.
  # The island's joint array — the Gauss-Seidel sweep order inside
  # b2Island::Solve — is therefore NOT joint-creation order. At the partial
  # convergence the reference runs (180 velocity iterations,
  # boxLCD/world_env.py:446-452), the sweep order changes the iterate by
  # ~1e-2 rad/step on articulated morphologies, so matching it matters for
  # trajectory parity. Bake the island order into the slot order itself so
  # every solver path (jnp / pallas / megakernel) inherits it.
  perm = list(range(len(j_parent)))
  if jn:
    edges = [[] for _ in range(n)]
    for j in range(jn):
      edges[j_parent[j]].insert(0, j)
      edges[j_child[j]].insert(0, j)
    perm, bflag, jflag = [], [False] * n, [False] * jn
    for seed in range(n - 1, -1, -1):
      if bflag[seed]:
        continue
      bflag[seed] = True
      stack = [seed]
      while stack:
        bb = stack.pop()
        for j in edges[bb]:
          if jflag[j]:
            continue
          jflag[j] = True
          perm.append(j)
          other = j_parent[j] if j_child[j] == bb else j_child[j]
          if not bflag[other]:
            bflag[other] = True
            stack.append(other)
    assert len(perm) == jn, (perm, jn)
    _pm = lambda lst: [lst[j] for j in perm]
    j_parent, j_child = _pm(j_parent), _pm(j_child)
    j_anchor_a, j_anchor_b = _pm(j_anchor_a), _pm(j_anchor_b)
    j_lower, j_upper, j_limited = _pm(j_lower), _pm(j_upper), _pm(j_limited)
    j_speed, j_torque, j_angle0 = _pm(j_speed), _pm(j_torque), _pm(j_angle0)
    joint_names = _pm(joint_names)
    j_rows = _pm(j_rows)

  # ---- action layout ------------------------------------------------------
  # actuated joints: limits differ (reference: boxLCD/world_env.py:109-114)
  act_info = {}
  for (pname, cname, joint), jname in zip(j_rows, joint_names):
    if joint.limits[0] != joint.limits[1]:
      suffix = 'speed' if G.get('use_speed', 1) else 'force'
      act_info[f'{jname}:{suffix}'] = (jname,)
  act_keys = tuple(sorted(act_info))
  jname_by_slot = joint_names + [''] * (len(j_parent) - jn)
  j_act = []
  for slot, jname in enumerate(jname_by_slot):
    hits = [k for k, key in enumerate(act_keys) if act_info[key][0] == jname] \
        if jname else []
    j_act.append(hits[0] if hits else -1)

  # ---- obs layout (sorted keys; reference: boxLCD/world_env.py:69-142) -----
  obs_info = {}
  src = {}  # key -> (body_idx, kind)
  for obj in objects:
    b = name2idx[obj.name]
    obs_info[f'{obj.name}:x:p'] = (0, width)
    src[f'{obj.name}:x:p'] = (b, KX)
    obs_info[f'{obj.name}:y:p'] = (0, height)
    src[f'{obj.name}:y:p'] = (b, KY)
    obs_info[f'{obj.name}:cos'] = (-1, 1)
    src[f'{obj.name}:cos'] = (b, KCOS)
    obs_info[f'{obj.name}:sin'] = (-1, 1)
    src[f'{obj.name}:sin'] = (b, KSIN)
  for robot in robots:
    b = name2idx[f'{robot.name}:root']
    obs_info[f'{robot.name}:root:x:p'] = (0, width)
    src[f'{robot.name}:root:x:p'] = (b, KX)
    obs_info[f'{robot.name}:root:y:p'] = (0, height)
    src[f'{robot.name}:root:y:p'] = (b, KY)
    obs_info[f'{robot.name}:root:cos'] = (-1, 1)
    src[f'{robot.name}:root:cos'] = (b, KCOS)
    obs_info[f'{robot.name}:root:sin'] = (-1, 1)
    src[f'{robot.name}:root:sin'] = (b, KSIN)
    for bj_name in robot.joints:
      bb = name2idx[f'{robot.name}:{bj_name}']
      # root_offset: positions relative to root, bounds [-2, 2]
      # (reference: world_env.py:95-100, 412-413)
      if root_offset:
        obs_info[f'{robot.name}:{bj_name}:x:p'] = (-2.0, 2.0)
        src[f'{robot.name}:{bj_name}:x:p'] = (bb, KX_REL)
        obs_info[f'{robot.name}:{bj_name}:y:p'] = (-2.0, 2.0)
        src[f'{robot.name}:{bj_name}:y:p'] = (bb, KY_REL)
      else:
        obs_info[f'{robot.name}:{bj_name}:x:p'] = (0, width)
        src[f'{robot.name}:{bj_name}:x:p'] = (bb, KX)
        obs_info[f'{robot.name}:{bj_name}:y:p'] = (0, height)
        src[f'{robot.name}:{bj_name}:y:p'] = (bb, KY)
      # angular_offset: angles relative to root (world_env.py:416-418)
      kcos, ksin = (KCOS_REL, KSIN_REL) if angular_offset else (KCOS, KSIN)
      obs_info[f'{robot.name}:{bj_name}:cos'] = (-1, 1)
      src[f'{robot.name}:{bj_name}:cos'] = (bb, kcos)
      obs_info[f'{robot.name}:{bj_name}:sin'] = (-1, 1)
      src[f'{robot.name}:{bj_name}:sin'] = (bb, ksin)
  obs_keys = tuple(sorted(obs_info))
  obs_bounds = _f([obs_info[k] for k in obs_keys])
  obs_body = _i([src[k][0] for k in obs_keys])
  obs_kind = _i([src[k][1] for k in obs_keys])
  pobs_keys = tuple(utils.nfiltlist(list(obs_keys), 'object'))
  pobs_idxs = _i([obs_keys.index(k) for k in pobs_keys])

  # teleport tables (reset from full_state)
  b_xi = np.zeros(n, np.int32)
  b_yi = np.zeros(n, np.int32)
  b_ci = np.zeros(n, np.int32)
  b_si = np.zeros(n, np.int32)
  for k, key in enumerate(obs_keys):
    b, kind = src[key]
    # REL variants (kind >= 4) fill the same x/y/cos/sin slots
    (b_xi, b_yi, b_ci, b_si)[kind % 4][b] = k

  # ---- collision pairs ----------------------------------------------------
  jointed = {(min(a, b), max(a, b)) for a, b in zip(j_parent[:jn], j_child[:jn])}
  pair_a, pair_b = [], []
  for i in range(n):
    for j in range(i + 1, n):
      if (i, j) in jointed:
        continue  # collideConnected=False for revolute joints
      if not ((mask[i] & category[j]) and (mask[j] & category[i])):
        continue
      pair_a.append(i)
      pair_b.append(j)
  pn = len(pair_a)
  if pn == 0:
    pair_a, pair_b = [0], [0]
  pair_valid = np.arange(len(pair_a)) < pn

  # ---- walls ---------------------------------------------------------------
  if G.get('walls', 1):
    wall_normal = _f([(0, 1), (1, 0), (-1, 0), (0, -1)])
    wall_offset = _f([0.0, 0.0, -width, -height])
  else:
    wall_normal = _f([(0, 1)])
    wall_offset = _f([0.0])

  fps = G.fps
  substeps = 3 if fps < 30 else 1
  dt = 1.0 / (fps * substeps)

  return WorldSpec(
      n=n, names=tuple(names),
      shape_static=_i(shape_static), radius=_f(radius),
      verts=_f(verts), nverts=_i(nverts), normals=_f(normals),
      draw_verts=_f(draw_verts),
      inv_m=_f(inv_m), inv_i=_f(inv_i), local_center=_f(local_center),
      friction=_f(friction), restitution=_f(restitution),
      lin_damp=_f(lin_damp), ang_damp=_f(ang_damp),
      jn=jn, j_parent=_i(j_parent), j_child=_i(j_child), j_order=_i(perm),
      j_anchor_a=_f(j_anchor_a), j_anchor_b=_f(j_anchor_b),
      j_lower=_f(j_lower), j_upper=_f(j_upper),
      j_limited=np.asarray(j_limited, bool), j_speed=_f(j_speed),
      j_torque=_f(j_torque), j_act=_i(j_act), j_valid=j_valid,
      j_angle0=_f(j_angle0),
      pair_a=_i(pair_a), pair_b=_i(pair_b), pair_valid=pair_valid,
      wall_normal=wall_normal, wall_offset=wall_offset,
      gravity=_f(world_def.gravity), dt=float(dt), substeps=int(substeps),
      vel_iters=int(G.get('vel_iters', DEFAULT_ITERS[0])),
      pos_iters=int(G.get('pos_iters', DEFAULT_ITERS[1])),
      solver_exit_tol=float(G.get('solver_exit_tol', 0.0)),
      width=width, height=height,
      role=_i(role), root_of=_i(root_of), parent_of=_i(parent_of),
      rs_rangex=_f(rs_rangex), rs_rangey_lo=_f(rs_rangey_lo),
      rs_rangey_hi=_f(rs_rangey_hi),
      rs_rand_angle=np.asarray(rs_rand_angle, bool),
      obs_keys=obs_keys, obs_bounds=obs_bounds, obs_body=obs_body,
      obs_kind=obs_kind, pobs_idxs=pobs_idxs, pobs_keys=pobs_keys,
      act_keys=act_keys,
      b_xi=b_xi, b_yi=b_yi, b_ci=b_ci, b_si=b_si,
      allow_sleep=bool(G.get('allow_sleep', 1)),
  )
