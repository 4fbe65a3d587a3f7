"""Whole-batch solver kernels: csrc/batched_solver.cu and its wrappers, for
the solver hooks of physics.step_world_batch.

The port of boxlcd_tpu/engine/pallas_solver.py (`make_batched_solver` and
`make_substep_solver`, whose pl.pallas_call runs the velocity iterations,
or the velocity iterations plus position integration and NGS, for the whole
world batch in one program). One CUDA kernel, templated on `with_position`,
serves both: one group of lanes per world (one lane per body, at
mega.launch_geometry) runs csrc/physics_stages.cuh's velocity_solve (and
position_solve) on that world's rows of the SolveBundle, the stages the
rollout megakernel runs too.

- `make_batched_solver(spec)` -> velocity_solver(bundle) -> bundle'
- `make_substep_solver(spec)` -> substep_solver(states, bundle, aux)
  -> (bundle', c, a)

For tensors on the CPU each takes its plain version (`plain_velocity_solver`,
`plain_substep_solver`: physics.velocity_solve and physics._position_solve);
for tensors on the card it launches the kernel or raises. The tracer's
counters `solver.velocity.launches` and `solver.substep.launches` count
the kernel's launches per kind.

The kernel takes every spec within csrc/physics_stages.cuh's maxima
(mega.check_limits raises ValueError beyond them), as boxlcd_tpu's kernel
takes every spec. The bundle's fields are read in physics.py's shapes and
dtypes (bool and int32 stay as they are; `w_mu` (N,) and `p_mu` (P,) are
spec constants, not per-world rows); the wrapper checks each field's shape,
dtype, device and contiguity and raises ValueError on any other. It writes
fresh tensors, so the bundle the caller holds is left as it was.

`solver_exit_tol`: the kernel, like the plain version, stops each world's
velocity iterations on its own once a sweep's largest impulse delta is <=
the tolerance. boxlcd_tpu's kernels ignore the tolerance and always run
`vel_iters` sweeps. At the default solver_exit_tol = 0 the two are the same.
"""
from __future__ import annotations

import ctypes

import torch

from boxlcd_tpu_torch import _build, trace
from boxlcd_tpu_torch.engine import mega, physics
from boxlcd_tpu_torch.engine.physics import SolveBundle
from boxlcd_tpu_torch.engine.spec import WorldSpec


def plain_velocity_solver(spec: WorldSpec, b: SolveBundle) -> SolveBundle:
  """The velocity iterations in plain torch (physics.velocity_solve)."""
  return physics.velocity_solve(spec, b)


def plain_substep_solver(spec: WorldSpec, states, b: SolveBundle, aux):
  """Velocity iterations, position integration and NGS in plain torch."""
  b = physics.velocity_solve(spec, b)
  c, a = physics._position_solve(spec, states, b, aux)
  return b, c, a


def _lib():
  lib = _build.load('batched_solver')
  sizes_fn = lib.batched_solver_sizes
  if sizes_fn.argtypes is None:
    mega.check_layout(lib)
    for fn in (lib.batched_velocity_launch, lib.batched_substep_launch):
      fn.argtypes = ([ctypes.c_void_p, ctypes.c_long] + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
      fn.restype = ctypes.c_int
    lib.batched_solver_occupancy.argtypes = [ctypes.c_int] * 4
    lib.batched_solver_occupancy.restype = ctypes.c_int
    sizes_fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    sizes_fn.restype = None
    nf, ni, nptrs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    sizes_fn(ctypes.byref(nf), ctypes.byref(ni), ctypes.byref(nptrs))
    lib.sizes = (nf.value, ni.value, nptrs.value)
  return lib


def _field_specs(spec: WorldSpec):
  """Per-world shape and dtype of each SolveBundle field, and of the position
  solve's inputs; a shape that starts with None is a spec constant (no
  worlds axis)."""
  n, nw = spec.n, len(spec.wall_offset)
  P, J = len(spec.pair_a), len(spec.j_parent)
  f32, i32, b8 = torch.float32, torch.int32, torch.bool
  bundle = {
      'v': (n, 2), 'w': (n,), 'j_imp': (J, 2), 'j_mot': (J,), 'j_lim': (J,),
      'wc': (n, nw, 2, 2), 'pc': (P, 2, 2), 'inv_m': (n,), 'inv_i': (n,),
      'j_rA': (J, 2), 'j_rB': (J, 2), 'j_axmass': (J,), 'j_state': (J,),
      'j_mA': (J,), 'j_mB': (J,), 'j_iA': (J,), 'j_iB': (J,),
      'motor_speed': (J,), 'w_rB': (n, nw, 2, 2), 'w_nmass': (n, nw, 2),
      'w_tmass': (n, nw, 2), 'w_bias': (n, nw, 2), 'w_mu': (None, n),
      'w_k': (n, nw, 2), 'w_k12': (n, nw), 'w_block': (n, nw),
      'p_n': (P, 2), 'p_rA': (P, 2, 2), 'p_rB': (P, 2, 2), 'p_nmass': (P, 2),
      'p_tmass': (P, 2), 'p_bias': (P, 2), 'p_mu': (None, P), 'p_imA': (P,),
      'p_imB': (P,), 'p_iiA': (P,), 'p_iiB': (P,), 'p_k': (P, 2),
      'p_k12': (P,), 'p_block': (P,)}
  assert tuple(bundle) == SolveBundle._fields
  dtypes = {f: f32 for f in bundle}
  dtypes.update(j_state=i32, w_block=b8, p_block=b8)
  position = {
      'c': ((n, 2), f32), 'a': ((n,), f32), 'j_ref': ((J,), f32),
      'lc': ((n, 2), f32), 'w_lps': ((n, nw, 2, 2), f32),
      'w_rad': ((n, nw), f32), 'w_touch': ((n, nw, 2), b8),
      'p_lps': ((P, 2, 2), f32), 'p_ln': ((P, 2), f32),
      'p_lpp': ((P, 2), f32), 'p_rad': ((P,), f32), 'p_mtype': ((P,), i32),
      'p_touch': ((P, 2), b8)}
  return {f: (s, dtypes[f]) for f, s in bundle.items()}, position


def _check(fields, B, dev):
  """Raise ValueError unless every tensor of `fields` (name -> (tensor,
  per-world shape, dtype)) has its shape, dtype and contiguity, and then
  unless each lies on `dev`, a CUDA device."""
  for name, (t, shape, dtype) in fields.items():
    want = tuple(shape[1:]) if shape and shape[0] is None else (B, *shape)
    if not torch.is_tensor(t) or t.dtype != dtype or tuple(t.shape) != want:
      got = (t.dtype, tuple(t.shape)) if torch.is_tensor(t) else type(t)
      raise ValueError(f'{name} must be {dtype} {want}, got {got}')
    if not t.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  for name, (t, _, _) in fields.items():
    if not t.is_cuda or t.device != dev:
      raise ValueError(f'{name} must lie on the same CUDA device as v')


class _Solver:
  """Shared launch logic of both hooks: the field checks, the spec tables
  on the device and the pointer array."""

  def __init__(self, spec: WorldSpec):
    mega.check_limits(spec)
    self.spec = spec
    self._tables = mega.spec_tables(spec)
    self._bundle_specs, self._position_specs = _field_specs(spec)
    self._dev = {}

  def occupancy(self, B: int, threads: int | None = None) -> int:
    """Resident blocks per SM of this hook's kernel at
    mega.launch_geometry(spec, B, threads)."""
    geo = mega.launch_geometry(self.spec, B, threads)
    return _lib().batched_solver_occupancy(int(self.with_position), geo.group,
                                           geo.worlds, geo.shared)

  def _launch(self, kind, b: SolveBundle, position, threads=None):
    """Check every input, allocate the outputs, launch at
    mega.launch_geometry(spec, B, threads); returns the bundle with the new
    carry and, with `position`, the new (c, a)."""
    B = b.v.shape[0] if b.v.dim() else -1
    dev = b.v.device
    fields = {f: (getattr(b, f), *s) for f, s in self._bundle_specs.items()}
    if position is not None:
      fields.update({f: (position[f], *s)
                     for f, s in self._position_specs.items()})
    _check(fields, B, dev)
    carry = {f: torch.empty_like(getattr(b, f))
             for f in ('v', 'w', 'j_imp', 'j_mot', 'j_lim', 'wc', 'pc')}
    ca = ((torch.empty_like(position['c']), torch.empty_like(position['a']))
          if position is not None else ())
    if B > 0:
      lib = _lib()
      ftab, itab = mega.device_tables(self._tables, lib.sizes[:2], dev,
                                      self._dev)
      pos = ([position[f].data_ptr() for f in self._position_specs]
             if position is not None else [0] * len(self._position_specs))
      ptrs = ([ftab.data_ptr(), itab.data_ptr()]
              + [getattr(b, f).data_ptr() for f in SolveBundle._fields] + pos
              + [t.data_ptr() for t in carry.values()]
              + ([t.data_ptr() for t in ca] if ca else [0, 0]))
      if len(ptrs) != lib.sizes[2]:
        raise RuntimeError(f'{len(ptrs)} pointers, the kernel reads '
                           f'{lib.sizes[2]}')
      fn = (lib.batched_substep_launch if position is not None
            else lib.batched_velocity_launch)
      arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
      spec = self.spec
      geo = mega.launch_geometry(spec, B, threads)
      with torch.cuda.device(dev):   # launch on the tensors' card
        err = fn(ctypes.cast(arr, ctypes.c_void_p), B, geo.group,
                 geo.worlds, len(spec.pair_a), len(spec.j_parent),
                 geo.shared, torch.cuda.current_stream(dev).cuda_stream)
      if err != 0:
        raise RuntimeError(f'batched_solver ({kind}) launch failed: '
                           f'cudaError {err}')
      trace.count(f'solver.{kind}.launches')
    return (b._replace(**carry), *ca)


class VelocitySolver(_Solver):
  """velocity_solver(bundle) -> bundle' for physics.step_world_batch."""

  with_position = False

  def __call__(self, b: SolveBundle) -> SolveBundle:
    if b.v.is_cuda:
      return self.kernel_solve(b)
    return self.plain_solve(b)

  def plain_solve(self, b: SolveBundle) -> SolveBundle:
    return plain_velocity_solver(self.spec, b)

  def kernel_solve(self, b: SolveBundle, threads=None) -> SolveBundle:
    """Launch csrc/batched_solver.cu (velocity only) on the current stream."""
    return self._launch('velocity', b, None, threads)[0]


class SubstepSolver(_Solver):
  """substep_solver(states, bundle, aux) -> (bundle', c, a) for
  physics.step_world_batch."""

  with_position = True

  def __call__(self, states, b: SolveBundle, aux):
    if b.v.is_cuda:
      return self.kernel_solve(states, b, aux)
    return self.plain_solve(states, b, aux)

  def plain_solve(self, states, b: SolveBundle, aux):
    return plain_substep_solver(self.spec, states, b, aux)

  def kernel_solve(self, states, b: SolveBundle, aux, threads=None):
    """Launch csrc/batched_solver.cu (velocity + position) on the current
    stream."""
    wm, pm = aux.wallm, aux.pairm
    position = {
        'c': states.c, 'a': states.a, 'j_ref': states.j_ref, 'lc': aux.lc,
        'w_lps': wm.lps, 'w_rad': wm.rad_sub, 'w_touch': wm.touch,
        'p_lps': pm.lps, 'p_ln': pm.ln, 'p_lpp': pm.lpp, 'p_rad': pm.rad_sub,
        'p_mtype': pm.mtype, 'p_touch': pm.touch}
    return self._launch('substep', b, position, threads)


_SOLVERS = {}


def _cached(cls, spec: WorldSpec):
  # the cache holds the spec, so its id is never reused while the entry lives
  key = (cls, id(spec))
  hit = _SOLVERS.get(key)
  if hit is None or hit.spec is not spec:
    hit = _SOLVERS[key] = cls(spec)
  return hit


def make_batched_solver(spec: WorldSpec) -> VelocitySolver:
  """velocity_solver(bundle) for step_world_batch: the velocity iterations of
  the whole batch in one kernel launch on the card."""
  return _cached(VelocitySolver, spec)


def make_substep_solver(spec: WorldSpec) -> SubstepSolver:
  """substep_solver(states, bundle, aux) for step_world_batch: velocity
  iterations, position integration and NGS of the whole batch in one kernel
  launch on the card; presolve and finalize stay plain torch."""
  return _cached(SubstepSolver, spec)
