"""The port's substep hook (engine/cuda_solver.py's make_substep_solver, its
plain version on the CPU) against boxlcd_tpu's Pallas substep kernel in
interpret mode, as tests/test_pallas.py runs it: test_pallas's warm states
(JAX resets plus 3 steps of one random action, at the kernel's 1024-world
block) and fields, within its 2e-3. The NGS exit flags are hard
thresholds, so a one-ulp disagreement costs one position iteration (~5e-4
on c).
"""
import jax
import numpy as np
import torch

import boxlcd_tpu
from boxlcd_tpu.engine import physics as jphys
from boxlcd_tpu.engine.pallas_solver import BLOCK
from boxlcd_tpu.engine.pallas_solver import \
    make_substep_solver as jax_substep_solver
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.engine import cuda_solver, physics
from boxlcd_tpu_torch.engine.spec import compile_world

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


def _jax_warm(env, B, steps=3):
  spec = env.spec
  keys = jax.random.split(jax.random.PRNGKey(0), B)
  states = jax.jit(jax.vmap(lambda k: JEnv.reset(env, k)))(keys)
  acts = jax.random.uniform(jax.random.PRNGKey(1), (B, env.act_size),
                            minval=-1, maxval=1)
  step = jax.jit(lambda s, a: jphys.step_world_batch(spec, s, a))
  for _ in range(steps):
    states = step(states, acts)
  return states, acts


def test_substep_hook_matches_pallas_kernel():
  env = boxlcd_tpu.env_map['UrchinBall']()
  spec = env.spec
  tspec = compile_world(env.world_def, env.G)
  states, acts = _jax_warm(env, BLOCK)
  ref = jphys.step_world_batch(
      spec, states, acts,
      substep_solver=jax_substep_solver(spec, interpret=True))
  ours = physics.step_world_batch(
      tspec, physics.state_from_numpy(states, 'cpu'),
      torch.as_tensor(np.array(acts)),
      substep_solver=cuda_solver.make_substep_solver(tspec))
  for f in ['v', 'w', 'c', 'a', 'wc_imp', 'pc_imp', 'j_imp', 'j_mot',
            'j_lim', 'sleep_time']:
    err = np.abs(np.asarray(getattr(ref, f)) - getattr(ours, f).numpy())
    assert err.max() < 2e-3, f'{f} mismatch {err.max()}'
