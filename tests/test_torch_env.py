"""The port's env layer vs boxlcd_tpu's: observations, teleport, reset, gym shell.

Observations are compared on JAX-made poses (full_state and proprio within
1e-6, frames exact); teleport on JAX-observed state vectors (poses within
1e-5). Reset is random (torch Philox and JAX threefry give different bits),
so it is checked against the spec's sampling ranges and invariants.
"""
import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.envs.env import Env

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

B = 24


def _pair(env_name, G):
  return (boxlcd_tpu.env_map[env_name](G),
          boxlcd_tpu_torch.env_map[env_name](G, device='cpu'))


def _jax_states(jenv, seed=0):
  keys = jax.random.split(jax.random.PRNGKey(seed), B)
  return jax.jit(jax.vmap(lambda k: JEnv.reset(jenv, k)))(keys)


def test_observe_and_teleport_match_jax():
  """Urchin with root-relative positions and angles: observe_pose, then
  teleport from the observed full_state and from proprio."""
  G = {'root_offset': 1, 'angular_offset': 1}
  jenv, env = _pair('Urchin', G)
  st = _jax_states(jenv)
  keys = jax.random.split(jax.random.PRNGKey(5), B)

  def jax_side(st, keys):
    obs = jax.vmap(jenv.observe_pose)(st.is_circle, st.c, st.a)
    tel = {src: jax.vmap(lambda k, x, src=src: JEnv.teleport(
        jenv, k, **{src: x}))(keys, obs[src])
           for src in ('full_state', 'proprio')}
    return obs, tel
  want, want_tel = jax.jit(jax_side)(st, keys)

  got = env.observe_pose(torch.as_tensor(np.asarray(st.is_circle)),
                         torch.as_tensor(np.asarray(st.c)),
                         torch.as_tensor(np.asarray(st.a)))
  assert set(got) == set(want)
  for k in ('full_state', 'proprio'):
    w, g = np.asarray(want[k]), got[k].numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, k
    assert np.abs(g - w).max() < 1e-6, k
  w, g = np.asarray(want['lcd']), got['lcd'].numpy()
  assert g.dtype == w.dtype and np.array_equal(g, w)

  for src, tel in want_tel.items():
    mine = Env.teleport(env, torch.Generator().manual_seed(5),
                        **{src: torch.as_tensor(np.asarray(want[src]))})
    for f in ('c', 'a'):
      err = np.abs(np.asarray(getattr(tel, f)) - getattr(mine, f).numpy())
      assert err.max() < 1e-5, f'teleport from {src}, {f}: {err.max()}'


def test_reset_ranges_and_invariants():
  n_worlds = 2000
  for name in ('Object3', 'Urchin', 'LuxoCube', 'Crab'):
    env = boxlcd_tpu_torch.env_map[name](device='cpu')
    s = env.spec
    st = Env.reset(env, torch.Generator().manual_seed(0), n_worlds)
    origin = physics.origin_pos(s, st).numpy()
    a = st.a.numpy()
    assert np.isfinite(origin).all() and (np.abs(a) <= np.pi + 1e-6).all()
    for i in range(s.n):
      if s.role[i] == 1:
        continue                   # children are placed from their joints
      rx = s.rs_rangex[i]
      x = origin[:, i, 0] / s.width * 2 - 1
      y = origin[:, i, 1] / s.height * 2 - 1
      assert (x >= -rx - 1e-5).all() and (x <= rx + 1e-5).all(), (name, i)
      assert (y >= s.rs_rangey_lo[i] - 1e-5).all(), (name, i)
      assert (y <= s.rs_rangey_hi[i] + 1e-5).all(), (name, i)
      if s.rs_rand_angle[i]:
        assert a[:, i].std() > 1.0, (name, i)   # spread over the circle
      else:
        assert (a[:, i] == 0).all(), (name, i)
      if s.shape_static[i] == 2:   # RANDOM: box|circle coin flip
        frac = st.is_circle[:, i].float().mean().item()
        assert abs(frac - 0.5) < 0.05, (name, i, frac)
      else:
        assert (st.is_circle[:, i].numpy() == (s.shape_static[i] == 0)).all()
    # revolute joint anchors coincide at reset
    for j in range(s.jn):
      pa, ch = s.j_parent[j], s.j_child[j]

      def anchor(b, local):
        ca, sa = np.cos(a[:, b]), np.sin(a[:, b])
        return origin[:, b] + np.stack([ca * local[0] - sa * local[1],
                                        sa * local[0] + ca * local[1]], -1)
      gap = np.abs(anchor(pa, s.j_anchor_a[j]) - anchor(ch, s.j_anchor_b[j]))
      assert gap.max() < 1e-4, (name, j, gap.max())
    ref = (a[:, s.j_child] - a[:, s.j_parent]) * s.j_valid
    assert np.allclose(st.j_ref.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize('env_name', ['Dropbox', 'Urchin', 'Object3',
                                      'LuxoCube', 'Crab'])
def test_world_env_surface_matches_jax(env_name):
  jenv, env = _pair(env_name, None)
  assert env.obs_keys == jenv.obs_keys and env.act_keys == jenv.act_keys
  assert env.pobs_keys == jenv.pobs_keys
  for k, space in jenv.observation_space.items():
    mine = env.observation_space[k]
    assert (mine.shape, np.dtype(mine.dtype)) == \
        (space.shape, np.dtype(space.dtype)), k
    assert (mine.low, mine.high) == (space.low, space.high), k
  assert env.action_space.shape == jenv.action_space.shape
  env.seed(3)
  obs = env.reset()
  obs2, rew, done, info = env.step(env.action_space.sample())
  for o in (obs, obs2):
    assert set(o) == set(jenv.observation_space.keys())
    for k, space in jenv.observation_space.items():
      assert o[k].shape == space.shape and o[k].dtype == np.dtype(space.dtype), k
  assert isinstance(rew, float) and done is False and info == {'timeout': False}
  frame = env.render('rgb_array')
  assert np.array_equal(frame, obs2['lcd'])
  again = env.reset(full_state=obs2['full_state'])
  assert np.abs(again['full_state'] - obs2['full_state']).max() < 1e-4
