"""The whole-batch solver hooks of the port's step_world_batch and their
kernel wrappers (engine/cuda_solver.py), on the CPU.

- The plain hooks give the step without hooks bit for bit.
- The port's velocity hook against JAX's plain step, within 1e-4 on v, w,
  c, a after one step (float noise of sums taken in another order).
- The kernel entry points check what they are given and raise ValueError.

tests/test_torch_pallas_solver.py holds the substep hook against
boxlcd_tpu's Pallas kernel.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.engine import physics as jphys
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.engine import cuda_solver, mega, physics
from boxlcd_tpu_torch.engine.spec import compile_world
from boxlcd_tpu_torch.envs.env import Env

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

ITERS = {'vel_iters': 8, 'pos_iters': 4}


def _torch_warm(env, B, steps=3):
  gen = torch.Generator().manual_seed(0)
  st = Env.reset(env, gen, B)
  act = torch.rand((B, env.act_size), generator=gen) * 2 - 1
  for _ in range(steps):
    st = physics.step_world_batch(env.spec, st, act)
  return st, act


def _jax_warm(env, B, steps=3):
  """tests/test_pallas.py's warm states: JAX resets, then a few steps of
  one random action to build contacts. Returns the step fn too."""
  spec = env.spec
  keys = jax.random.split(jax.random.PRNGKey(0), B)
  states = jax.jit(jax.vmap(lambda k: JEnv.reset(env, k)))(keys)
  acts = jax.random.uniform(jax.random.PRNGKey(1), (B, env.act_size),
                            minval=-1, maxval=1)
  step = jax.jit(lambda s, a: jphys.step_world_batch(spec, s, a))
  for _ in range(steps):
    states = step(states, acts)
  return states, acts, step


@pytest.mark.parametrize('env_name', ['Urchin', 'LuxoCube'])
@pytest.mark.parametrize('hook', ['velocity', 'substep'])
def test_plain_hooks_are_bit_identical(env_name, hook):
  env = boxlcd_tpu_torch.env_map[env_name](ITERS, device='cpu')
  spec = env.spec
  st, act = _torch_warm(env, 32, steps=2)
  want = physics.step_world_batch(spec, st, act)
  if hook == 'velocity':
    solver = cuda_solver.make_batched_solver(spec)
    explicit = lambda b: cuda_solver.plain_velocity_solver(spec, b)
  else:
    solver = cuda_solver.make_substep_solver(spec)
    explicit = lambda s, b, a: cuda_solver.plain_substep_solver(spec, s, b, a)
  launches = lambda: {k: trace.counter(f'solver.{k}.launches')
                      for k in ('velocity', 'substep')}
  before = launches()
  for fn in (solver, explicit):
    got = physics.step_world_batch(spec, st, act, **{f'{hook}_solver': fn})
    for f in physics.WorldState._fields:
      assert torch.equal(getattr(got, f), getattr(want, f)), (hook, f)
  assert launches() == before     # the CPU takes the plain version


def test_velocity_hook_matches_jax_plain_step():
  env = boxlcd_tpu.env_map['LuxoCube']()
  tspec = compile_world(env.world_def, env.G)
  states, acts, step = _jax_warm(env, 32)
  ref = step(states, acts)
  ours = physics.step_world_batch(
      tspec, physics.state_from_numpy(states, 'cpu'),
      torch.as_tensor(np.asarray(acts)),
      velocity_solver=cuda_solver.make_batched_solver(tspec))
  assert int(np.asarray(ref.wc_id >= 0).sum()) > 0      # contacts in play
  for f in ['v', 'w', 'c', 'a']:
    err = np.abs(np.asarray(getattr(ref, f)) - getattr(ours, f).numpy())
    assert err.max() < 1e-4, f'{f} mismatch {err.max()}'


def test_kernel_entries_check_their_inputs():
  env = boxlcd_tpu_torch.env_map['LuxoCube'](ITERS, device='cpu')
  spec = env.spec
  st, act = _torch_warm(env, 4, steps=1)
  K = physics.consts(spec, 'cpu')
  b, aux = physics._presolve(spec, K, st, physics.motor_speeds(spec, act))
  vel = cuda_solver.make_batched_solver(spec)
  sub = cuda_solver.make_substep_solver(spec)
  with pytest.raises(ValueError, match='CUDA device'):     # CPU tensors
    vel.kernel_solve(b)
  with pytest.raises(ValueError, match='CUDA device'):
    sub.kernel_solve(st, b, aux)
  with pytest.raises(ValueError, match='torch.float32'):   # float64 field
    vel.kernel_solve(b._replace(w_bias=b.w_bias.double()))
  with pytest.raises(ValueError, match='torch.int32'):     # int64 j_state
    vel.kernel_solve(b._replace(j_state=b.j_state.long()))
  with pytest.raises(ValueError, match='w_mu'):            # per-world w_mu
    vel.kernel_solve(b._replace(w_mu=b.w_mu.expand(4, -1).contiguous()))
  with pytest.raises(ValueError, match='contiguous'):
    vel.kernel_solve(b._replace(p_rA=b.p_rA.transpose(2, 3).contiguous()
                                .transpose(2, 3)))
  with pytest.raises(ValueError, match='p_mtype'):         # int64 mtype
    sub.kernel_solve(st, b, aux._replace(pairm=aux.pairm._replace(
        mtype=aux.pairm.mtype.long())))
  with pytest.raises(ValueError, match=r'\(4, 5, 2\)'):    # shape of states.c
    sub.kernel_solve(st._replace(c=st.c[:, :, :1].contiguous()), b, aux)
  with pytest.raises(ValueError):       # beyond the kernel's maxima
    cuda_solver.make_substep_solver(
        dataclasses.replace(spec, n=mega.MAX_BODIES + 1))
