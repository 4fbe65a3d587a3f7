"""The port's rollout (engine/mega.py) vs boxlcd_tpu's rollout megakernel.

The same JAX-reset states and numpy-made motor speeds go through JAX
`mega.make_rollout(spec, T, interpret=True)` (the Pallas kernel in interpret
mode, as tests/test_mega.py runs it) and the port's `mega.make_rollout` on
the CPU, whose plain version is T calls of `physics.step_world_motor`.
Agreement is float-noise-limited: the two sum warm-start and Gauss-Seidel
terms in another order, and contact dynamics amplify ~1e-7 differences in a
few worlds. So every field of tests/test_mega.py's FIELDS is held to that
file's per-env bounds (median per-world error, and the fraction of worlds
above a tail threshold); poses after step 0, before chaos grows, agree
within 1e-4 everywhere.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.engine import mega as jmega
from boxlcd_tpu.envs.env import Env
from boxlcd_tpu_torch.engine import mega, physics

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

FIELDS = ['c', 'a', 'v', 'w', 'sleep_time', 'wc_imp', 'j_imp', 'j_mot',
          'j_lim', 'j_state', 'prev_motor', 'pc_imp', 'pc_id']
# (median, tail threshold, tail fraction): tests/test_mega.py's BOUNDS
BOUNDS = {'Urchin': (1e-4, 5e-3, 0.03), 'Object3': (1.5e-3, 5e-2, 0.2)}
B = jmega.BLOCK        # 1024 worlds: one tile of the JAX kernel
T = 6                  # 4 random-action steps, then zero actions


@pytest.mark.parametrize('env_name', list(BOUNDS))
def test_rollout_matches_jax_megakernel(env_name):
  med_bound, tail_at, tail_frac = BOUNDS[env_name]
  env = boxlcd_tpu.env_map[env_name]()
  spec = env.spec
  tspec = boxlcd_tpu_torch.env_map[env_name](device='cpu').spec
  keys = jax.random.split(jax.random.PRNGKey(0), B)
  states = jax.jit(jax.vmap(lambda k: Env.reset(env, k)))(keys)
  rng = np.random.default_rng(0)
  ms = np.concatenate([
      rng.uniform(-1, 1, (4, B, len(spec.j_parent)))
      * (spec.j_act >= 0) * spec.j_speed,
      np.zeros((T - 4, B, len(spec.j_parent)))]).astype(np.float32)
  ref, ref_traj = jax.jit(jmega.make_rollout(spec, T, interpret=True))(
      states, ms)

  ours = physics.state_from_numpy(states, 'cpu')
  new, traj = mega.make_rollout(tspec, T)(ours, torch.as_tensor(ms))
  assert np.array_equal(new.ep_t.numpy(), np.asarray(states.ep_t) + T)
  for f in FIELDS:
    r = np.asarray(getattr(ref, f), np.float32)
    m = getattr(new, f).numpy().astype(np.float32)
    assert r.shape == m.shape, f
    err = np.abs(r - m).reshape(B, -1).max(axis=1)
    assert np.median(err) < med_bound, f'{f} median {np.median(err)}'
    assert (err > tail_at).mean() < tail_frac, f'{f} tail {(err > tail_at).mean()}'
  assert traj['c'].shape == (T, B, tspec.n, 2)
  assert traj['a'].shape == (T, B, tspec.n)
  assert np.abs(traj['c'][0].numpy() - np.asarray(ref_traj['c'][0])).max() < 1e-4
  assert np.abs(traj['a'][0].numpy() - np.asarray(ref_traj['a'][0])).max() < 1e-4
  # the stream holds the final poses as its last step
  assert torch.equal(traj['c'][-1], new.c) and torch.equal(traj['a'][-1], new.a)


def test_supports_agrees_with_jax():
  for name in boxlcd_tpu.env_map:
    spec = boxlcd_tpu_torch.env_map[name](device='cpu').spec
    assert mega.supports(spec) == jmega.supports(boxlcd_tpu.env_map[name]().spec), name
    mega.check_limits(spec)           # the whole zoo fits the kernel


def test_limits_and_tables():
  spec = boxlcd_tpu_torch.env_map['CrabCube'](device='cpu').spec
  ftab, itab = mega.spec_tables(spec)
  assert ftab.dtype == np.float32 and itab.dtype == np.int32
  assert itab[0] == spec.n and itab[3] == len(spec.j_parent)
  assert itab[4] == len(spec.pair_a) <= mega.MAX_PAIRS
  too_many = dataclasses.replace(spec, n=mega.MAX_BODIES + 1)
  with pytest.raises(ValueError):
    mega.make_rollout(too_many, 2)
