"""The port's torch physics vs boxlcd_tpu's jnp step path.

The same JAX-reset states and numpy-made actions go through JAX
`physics.step_world_batch` and the port's `step_world_batch` on the CPU.
Agreement is float-noise-limited (sums run in another order, and contact
dynamics amplify ~1e-7 differences in a few worlds), so every field of
tests/test_mega.py's FIELDS is held to that file's per-env bounds: median
per-world error, and the fraction of worlds above a tail threshold. Poses
after the first step, before chaos grows, agree within 1e-4 everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
from boxlcd_tpu.engine import physics as jphys
from boxlcd_tpu.envs.env import Env
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.engine.spec import compile_world

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

FIELDS = ['c', 'a', 'v', 'w', 'sleep_time', 'wc_imp', 'j_imp', 'j_mot',
          'j_lim', 'j_state', 'prev_motor', 'pc_imp', 'pc_id']
# (median, tail threshold, tail fraction): tests/test_mega.py's BOUNDS
BOUNDS = {
    'Urchin': (1e-4, 5e-3, 0.03),
    'LuxoCube': (1e-4, 5e-3, 0.03),
    'Bounce2': (1e-4, 5e-3, 0.03),
    'Object3': (1.5e-3, 5e-2, 0.2),
}
B = 32
T = 6   # 4 random-action steps, then zero actions


def _jax_states(env, seed=0):
  keys = jax.random.split(jax.random.PRNGKey(seed), B)
  return jax.jit(jax.vmap(lambda k: Env.reset(env, k)))(keys)


@pytest.mark.parametrize('env_name,G', [
    ('Urchin', {}), ('LuxoCube', {}), ('Bounce2', {}), ('Object3', {}),
    ('Urchin', {'solver_exit_tol': 1e-4}),
], ids=['Urchin', 'LuxoCube', 'Bounce2', 'Object3', 'Urchin-exit_tol'])
def test_step_world_batch_matches_jax(env_name, G):
  med_bound, tail_at, tail_frac = BOUNDS[env_name]
  env = boxlcd_tpu.env_map[env_name](G)
  spec = env.spec
  tspec = compile_world(env.world_def, env.G)
  assert tspec.solver_exit_tol == spec.solver_exit_tol
  states = _jax_states(env)
  rng = np.random.default_rng(0)
  acts = np.concatenate([
      rng.uniform(-1, 1, (4, B, env.act_size)),
      np.zeros((T - 4, B, env.act_size))]).astype(np.float32)
  step = jax.jit(lambda s, a: jphys.step_world_batch(spec, s, a))
  ref = states
  ours = physics.state_from_numpy(states, 'cpu')
  for t in range(T):
    ref = step(ref, acts[t])
    ours = physics.step_world_batch(tspec, ours, torch.as_tensor(acts[t]))
    if t == 0:
      for f in ('c', 'a'):
        err = np.abs(np.asarray(getattr(ref, f)) - getattr(ours, f).numpy())
        assert err.max() < 1e-4, f'{f} after the first step: {err.max()}'
  got = physics.state_to_numpy(ours)
  for f in FIELDS:
    r = np.asarray(getattr(ref, f))
    assert got[f].dtype == r.dtype and got[f].shape == r.shape, f
    err = np.abs(r.astype(np.float32) - got[f].astype(np.float32))
    err = err.reshape(B, -1).max(axis=1)                 # per world
    assert np.median(err) < med_bound, f'{f} median {np.median(err)}'
    assert (err > tail_at).mean() < tail_frac, \
        f'{f} tail {(err > tail_at).mean()}'


def test_init_state_matches_jax():
  env = boxlcd_tpu.env_map['LuxoCube']({})
  tspec = compile_world(env.world_def, env.G)
  ref = jax.vmap(lambda _: jphys.init_state(env.spec))(jnp.arange(3))
  got = physics.state_to_numpy(physics.init_state(tspec, 3, 'cpu'))
  for f in physics.WorldState._fields:
    r = np.asarray(getattr(ref, f))
    assert got[f].dtype == r.dtype and got[f].shape == r.shape, f
    assert np.array_equal(got[f], r), f
  back = physics.state_to_numpy(physics.state_from_numpy(got, 'cpu'))
  for f in physics.WorldState._fields:
    assert np.array_equal(back[f], got[f]), f
