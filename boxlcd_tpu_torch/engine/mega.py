"""Rollout megakernel: T env steps in one launch, csrc/mega_rollout.cu and its
wrapper.

The port of boxlcd_tpu/engine/mega.py (`make_rollout`, whose pl.pallas_call
runs the whole substep pipeline for T steps per world tile). The kernel runs
every substep of engine/physics.py / engine/collision.py for T steps, one
group of lanes per world (one lane per body; `launch_geometry`): velocity
integration and damping, the wall and body-pair narrowphase (circle-circle,
polygon-circle, polygon-polygon SAT + clip, with RANDOM shapes chosen per
world), warm-start matching by contact id,
constraint init, `vel_iters` Gauss-Seidel sweeps (revolute joints with motor
and limits, the 2-point block LCP), position integration and `pos_iters` NGS
with Box2D's per-world exit, island sleeping, and the warm-start writeback.
It writes each step's poses into a pose stream (T, N, 3, B) (x, y, angle;
worlds minor), the layout render/traj_raster.py reads.

One build serves every env: the spec goes in as two small tables
(`spec_tables`, laid out as csrc/physics_stages.cuh's SpecF / SpecI) under
compile-time maxima that cover the env zoo; a spec beyond them raises
ValueError. `launch_geometry` sizes the launch from the spec and the batch:
the group size, worlds a block, blocks and the dynamic shared memory of the
worlds' shared state (csrc/physics_stages.cuh's World layout, mirrored
here); the solver kernels (engine/cuda_solver.py) use it too.

`solver_exit_tol`: the kernel, like the plain version (physics.velocity_solve),
stops each world's velocity iterations on its own once a sweep's largest
impulse delta is <= the tolerance. boxlcd_tpu's kernel stops a whole
1024-world tile on the tile's largest delta (mega.py:1211-1227). At the
default solver_exit_tol = 0 the two are the same.

For tensors on the CPU the rollout takes the plain version (T calls of
physics.step_world_motor); for tensors on the card it launches the kernel or
raises. The tracer's counter `mega_rollout.launches` counts the kernel's
launches, and `mega_rollout.counted_launches` those of its counted
instance. While tracing is on, the launch takes the counted instance,
which adds each world's NGS position iterations and substeps
(`mega_rollout.ngs_iters`, `mega_rollout.world_substeps`) into a per-world
buffer (trace.world_counts); the plain version counts the same under
`physics.*` (physics.step_world_motor).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from boxlcd_tpu_torch import _build, trace
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.engine.physics import WorldState
from boxlcd_tpu_torch.engine.spec import RANDOM, WorldSpec
from boxlcd_tpu_torch.utils import NUM_SMS

# the per-world counters of the kernel's counted instance, in its order
COUNTS = ('mega_rollout.ngs_iters', 'mega_rollout.world_substeps')

# csrc/physics_stages.cuh's compile-time maxima
MAX_BODIES, MAX_JOINTS, MAX_PAIRS, MAX_WALLS, MAX_VERTS = 18, 16, 15, 4, 8

# csrc/physics_stages.cuh's shared layout of one world: BODY_ARRAYS arrays of
# G words, a PAIR_WORDS record per pair slot, a JOINT_WORDS record per joint
# slot (the launch functions check the sizes this gives against their own)
BODY_ARRAYS, PAIR_WORDS, JOINT_WORDS = 18, 48, 18
GROUP_SIZES = (4, 8, 16, 32)       # the group sizes the kernels are built for
BLOCK_THREADS = (128, 64, 32)      # the block sizes launch_geometry picks from


class Geometry(NamedTuple):
  """One launch of a physics kernel: `group` lanes a world, `worlds` a block,
  `blocks` blocks, `shared` bytes of dynamic shared memory a block."""
  group: int
  worlds: int
  blocks: int
  shared: int

  @property
  def threads(self):
    return self.group * self.worlds


def group_size(spec: WorldSpec) -> int:
  """Lanes a world: the spec's bodies rounded up to a power of two, >= 4."""
  return max(4, 1 << max(0, spec.n - 1).bit_length())


def world_words(G: int, n_pairs: int, n_joints: int) -> int:
  """4-byte words of one world's shared state (physics_stages.cuh's
  world_words): padded to G mod 32, so that the worlds of a warp start G
  banks apart."""
  w = BODY_ARRAYS * G + PAIR_WORDS * n_pairs + JOINT_WORDS * n_joints
  return w + ((G % 32) - w % 32) % 32


def launch_geometry(spec: WorldSpec, B: int, threads: int | None = None):
  """The launch of a physics kernel for B worlds of `spec`. Blocks hold the
  most threads of BLOCK_THREADS that still give each of the card's SMs a
  block (else the fewest), so a batch of a few thousand worlds covers every
  SM; `threads` fixes the block size instead (chip_smoke.py times the
  others)."""
  G = group_size(spec)
  if G > GROUP_SIZES[-1]:
    raise ValueError(f'physics kernels: {spec.n} bodies, at most '
                     f'{GROUP_SIZES[-1]}')
  if threads is None:
    fits = [t for t in BLOCK_THREADS if t >= G and -(-B * G // t) >= NUM_SMS]
    threads = fits[0] if fits else max(G, BLOCK_THREADS[-1])
  if threads % G or threads > BLOCK_THREADS[0]:
    raise ValueError(f'{threads} threads a block do not hold groups of {G}')
  worlds = threads // G
  shared = worlds * world_words(G, len(spec.pair_a), len(spec.j_parent)) * 4
  return Geometry(G, worlds, -(-B // worlds), shared)


# WorldState fields the kernel updates, in csrc/mega_rollout.cu's Ptrs order
_STATE_FIELDS = ('c', 'a', 'v', 'w', 'sleep_time', 'wc_imp', 'wc_id',
                 'pc_imp', 'pc_id', 'j_imp', 'j_mot', 'j_lim', 'j_ref',
                 'prev_motor', 'j_state')


def supports(spec: WorldSpec) -> bool:
  """boxlcd_tpu's rule: joints never attach to RANDOM-shape bodies, and a
  RANDOM body's two mass variants share a local center."""
  for j in range(spec.jn):
    for b in (int(spec.j_parent[j]), int(spec.j_child[j])):
      if int(spec.shape_static[b]) == RANDOM:
        return False
  for i in range(spec.n):
    if int(spec.shape_static[i]) == RANDOM and not np.allclose(
        spec.local_center[i, 0], spec.local_center[i, 1]):
      return False
  return True


def check_limits(spec: WorldSpec):
  """Raise ValueError for a spec beyond the kernel's compile-time maxima."""
  sizes = {'bodies': (spec.n, MAX_BODIES),
           'joint slots': (len(spec.j_parent), MAX_JOINTS),
           'pair slots': (len(spec.pair_a), MAX_PAIRS),
           'walls': (len(spec.wall_offset), MAX_WALLS),
           'polygon vertices': (spec.verts.shape[1], MAX_VERTS)}
  for what, (got, most) in sizes.items():
    if got > most:
      raise ValueError(f'megakernel: {got} {what}, at most {most}')


def _pad(x, shape, dtype):
  out = np.zeros(shape, dtype)
  x = np.asarray(x, dtype)
  out[tuple(slice(0, s) for s in x.shape)] = x
  return out


def spec_tables(spec: WorldSpec):
  """(float32 table, int32 table) in csrc/physics_stages.cuh's SpecF / SpecI
  layout. Derived constants come from physics.consts, as the plain version
  uses them."""
  check_limits(spec)
  K = physics.consts(spec, 'cpu')
  k = lambda t: t.numpy() if torch.is_tensor(t) else np.asarray(t)
  NB, NJ, NP, NW, NV = MAX_BODIES, MAX_JOINTS, MAX_PAIRS, MAX_WALLS, MAX_VERTS
  f32 = np.float32
  ftab = [
      _pad([spec.dt, spec.solver_exit_tol], (2,), f32), k(K.dtg),
      _pad(spec.inv_m, (NB, 2), f32), _pad(spec.inv_i, (NB, 2), f32),
      _pad(spec.local_center, (NB, 2, 2), f32), _pad(spec.radius, (NB,), f32),
      _pad(k(K.verts_com), (NB, NV, 2), f32),
      _pad(k(K.normals), (NB, NV, 2), f32),
      _pad(k(K.lin_div), (NB,), f32), _pad(k(K.ang_div), (NB,), f32),
      _pad(k(K.w_mu), (NB,), f32), _pad(k(K.w_e), (NB,), f32),
      _pad(spec.wall_normal, (NW, 2), f32), _pad(spec.wall_offset, (NW,), f32),
      _pad(k(K.p_mu), (NP,), f32), _pad(k(K.p_e), (NP,), f32),
      _pad(spec.j_anchor_a, (NJ, 2), f32), _pad(spec.j_anchor_b, (NJ, 2), f32),
      _pad(spec.j_lower, (NJ,), f32), _pad(spec.j_upper, (NJ,), f32),
      _pad(K.j_cap, (NJ,), f32), _pad(k(K.j_validf), (NJ,), f32),
  ]
  n = spec.n
  i32 = np.int32
  itab = [
      np.array([n, len(spec.wall_offset), spec.jn, len(spec.j_parent),
                len(spec.pair_a), spec.substeps, spec.vel_iters,
                spec.pos_iters, int(spec.allow_sleep),
                max(1, int(np.ceil(np.log2(max(n, 2))))) + 1], i32),
      _pad(spec.nverts, (NB,), i32),
      _pad(spec.pair_a, (NP,), i32), _pad(spec.pair_b, (NP,), i32),
      _pad(spec.pair_valid, (NP,), i32),
      _pad(spec.j_parent, (NJ,), i32), _pad(spec.j_child, (NJ,), i32),
      _pad(spec.j_limited, (NJ,), i32), _pad(k(K.j_equal), (NJ,), i32),
      _pad(spec.j_valid, (NJ,), i32),
  ]
  return (np.concatenate([x.ravel() for x in ftab]).astype(f32),
          np.concatenate([x.ravel() for x in itab]).astype(i32))


def device_tables(tables, sizes, device, cache):
  """The (float32, int32) spec tables as tensors on `device`, kept in
  `cache`; raises RuntimeError unless their lengths are `sizes`, the words
  the kernel reads."""
  key = str(device)
  if key not in cache:
    ftab, itab = tables
    if (len(ftab), len(itab)) != tuple(sizes):
      raise RuntimeError(f'spec tables hold {len(ftab)}/{len(itab)} words, '
                         f'the kernel reads {tuple(sizes)}')
    cache[key] = (torch.as_tensor(ftab, device=device),
                  torch.as_tensor(itab, device=device))
  return cache[key]


def check_layout(lib):
  """Raise RuntimeError unless the built kernels' shared layout is the one
  BODY_ARRAYS, PAIR_WORDS and JOINT_WORDS mirror."""
  got = [ctypes.c_int() for _ in range(3)]
  lib.phys_layout(*(ctypes.byref(x) for x in got))
  got = tuple(x.value for x in got)
  if got != (BODY_ARRAYS, PAIR_WORDS, JOINT_WORDS):
    raise RuntimeError(f'the kernels\' shared layout is {got}, engine/mega.py '
                       f'mirrors {(BODY_ARRAYS, PAIR_WORDS, JOINT_WORDS)}')


def _lib():
  lib = _build.load('mega_rollout')
  fn = lib.mega_rollout_launch
  if fn.argtypes is None:
    check_layout(lib)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_long]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    lib.mega_rollout_occupancy.argtypes = [ctypes.c_int] * 3
    lib.mega_rollout_occupancy.restype = ctypes.c_int
    nf, ni = ctypes.c_int(), ctypes.c_int()
    lib.mega_table_sizes(ctypes.byref(nf), ctypes.byref(ni))
    fn.table_sizes = (nf.value, ni.value)
    fn.occupancy = lib.mega_rollout_occupancy
  return fn


def flat_poses(stream, is_circle):
  """A (T, N, 3, B) pose stream as T * B frames, time major: (is_circle
  (T*B, N), c (T*B, N, 2), a (T*B, N)), the inputs of Env.observe_pose."""
  T, n, _, B = stream.shape
  c = stream[:, :, :2].permute(0, 3, 1, 2).reshape(T * B, n, 2)
  a = stream[:, :, 2].permute(0, 2, 1).reshape(T * B, n)
  ic = is_circle[None].expand(T, B, n).reshape(T * B, n)
  return ic, c, a


def _traj(stream):
  """Pose views of a (T, N, 3, B) stream: c (T, B, N, 2), a (T, B, N)."""
  v = stream.permute(0, 3, 1, 2)
  return {'c': v[..., :2], 'a': v[..., 2], 'stream': stream}


class Rollout:
  """rollout(states, motor_speed (T, B, J)) -> (states', traj): T env steps
  of every world. traj holds the post-step poses c (T, B, N, 2) and
  a (T, B, N) as views of the pose stream (T, N, 3, B), under 'stream'."""

  def __init__(self, spec: WorldSpec, T: int):
    check_limits(spec)
    if not supports(spec):
      raise ValueError('megakernel: unsupported spec (see supports())')
    self.spec, self.T = spec, int(T)
    self._tables = spec_tables(spec)
    self._dev = {}

  def __call__(self, states: WorldState, motor_speed):
    if states.c.is_cuda:
      return self.kernel_rollout(states, motor_speed)
    return self.plain_rollout(states, motor_speed)

  def plain_rollout(self, states: WorldState, motor_speed, counts=None):
    """T calls of physics.step_world_motor, recording the poses; `counts`
    is step_world_motor's."""
    spec = self.spec
    B = states.c.shape[0]
    stream = torch.empty((self.T, spec.n, 3, B), device=states.c.device)
    for t in range(self.T):
      states = physics.step_world_motor(spec, states, motor_speed[t],
                                        counts=counts)
      stream[t, :, :2] = states.c.permute(1, 2, 0)
      stream[t, :, 2] = states.a.T
    return states, _traj(stream)

  def _check(self, states: WorldState, motor_speed):
    spec = self.spec
    B = states.c.shape[0]
    n, nw = spec.n, len(spec.wall_offset)
    P, J = len(spec.pair_a), len(spec.j_parent)
    want = {'c': (n, 2), 'a': (n,), 'v': (n, 2), 'w': (n,),
            'is_circle': (n,), 'sleep_time': (n,),
            'wc_imp': (n, nw, 2, 2), 'wc_id': (n, nw, 2),
            'pc_imp': (P, 2, 2), 'pc_id': (P, 2), 'j_imp': (J, 2),
            'j_mot': (J,), 'j_lim': (J,), 'j_ref': (J,), 'prev_motor': (J,),
            'j_state': (J,)}
    dev = states.c.device
    for f, shape in want.items():
      t = getattr(states, f)
      dtype = (torch.bool if f == 'is_circle' else torch.int32
               if f in physics._INT_FIELDS else torch.float32)
      if not t.is_cuda or t.device != dev:
        raise ValueError(f'{f} must lie on the same CUDA device as c')
      if t.dtype != dtype or tuple(t.shape) != (B, *shape):
        raise ValueError(f'{f} must be {dtype} {(B, *shape)}, got {t.dtype} '
                         f'{tuple(t.shape)}')
      if not t.is_contiguous():
        raise ValueError(f'{f} must be contiguous')
    ms = motor_speed
    if not ms.is_cuda or ms.device != dev:
      raise ValueError('motor_speed must lie on the same CUDA device as c')
    if ms.dtype != torch.float32 or tuple(ms.shape) != (self.T, B, J):
      raise ValueError(f'motor_speed must be float32 {(self.T, B, J)}, got '
                       f'{ms.dtype} {tuple(ms.shape)}')
    if not ms.is_contiguous():
      raise ValueError('motor_speed must be contiguous')

  def occupancy(self, B: int, threads: int | None = None) -> int:
    """Resident blocks per SM at launch_geometry(spec, B, threads)
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    geo = launch_geometry(self.spec, B, threads)
    return _lib().occupancy(geo.group, geo.worlds, geo.shared)

  def kernel_rollout(self, states: WorldState, motor_speed,
                     threads: int | None = None, counts=None):
    """Launch csrc/mega_rollout.cu on the current stream, at
    launch_geometry(spec, B, threads). `counts`, a (B, 2) int64 tensor on
    the card, takes the counted instance, which adds each world's NGS
    iterations and substeps (COUNTS) into its row; while tracing is on it
    defaults to the tracer's buffer."""
    self._check(states, motor_speed)
    spec = self.spec
    B = states.c.shape[0]
    dev = states.c.device
    out = {f: getattr(states, f).clone() for f in _STATE_FIELDS}
    stream = torch.empty((self.T, spec.n, 3, B), device=dev)
    new = states._replace(**out, ep_t=states.ep_t + self.T)
    if B == 0:
      return new, _traj(stream)
    if counts is None:
      counts = trace.world_counts(COUNTS, B, dev)
    if counts is not None and (counts.device != dev or counts.dtype !=
                               torch.int64 or tuple(counts.shape) != (B, 2)
                               or not counts.is_contiguous()):
      raise ValueError(f'counts must be a contiguous int64 {(B, 2)} tensor on '
                       f'{dev}')
    fn = _lib()
    ftab, itab = device_tables(self._tables, fn.table_sizes, dev, self._dev)
    ptrs = [ftab, itab, states.is_circle, *(out[f] for f in _STATE_FIELDS),
            motor_speed, stream]
    arr = (ctypes.c_void_p * len(ptrs))(*(t.data_ptr() for t in ptrs))
    geo = launch_geometry(spec, B, threads)
    with torch.cuda.device(dev):     # launch on the tensors' card
      err = fn(ctypes.cast(arr, ctypes.c_void_p), B, self.T, geo.group,
               geo.worlds, len(spec.pair_a), len(spec.j_parent), geo.shared,
               None if counts is None else counts.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
      raise RuntimeError(f'mega_rollout launch failed: cudaError {err}')
    trace.count('mega_rollout.launches')
    if counts is not None:
      trace.count('mega_rollout.counted_launches')
    return new, _traj(stream)


_ROLLOUTS = {}


def make_rollout(spec: WorldSpec, T: int) -> Rollout:
  """The T-step rollout of `spec`; cached (the cache holds the spec, so its
  id is never reused)."""
  key = (id(spec), int(T))
  hit = _ROLLOUTS.get(key)
  if hit is None or hit.spec is not spec:
    hit = _ROLLOUTS[key] = Rollout(spec, T)
  return hit
