"""The port's goal wrappers and vector shells vs boxlcd_tpu's
(research/wrappers), on the CPU.

- VecEnv in cube mode against JAX's (tests/test_torch_vec_env.py's
  comparison and bounds), on Dropbox: its one body is the object.
- BodyGoalEnv / CubeGoalEnv comp_rew_done equal to the JAX wrappers' on the
  same obs dicts, every reward branch, and both wrappers over the port's
  WorldEnv.
- SyncVectorEnv and WrappedGym equal to the JAX shells over a small fake
  gym env (there is no gym package), with gym's and gymnasium's step API.
"""
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research import wrappers as twrap
from research import wrappers as jwrap
from tests.test_torch_vec_env import _step_both, rl_G

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


def test_vec_env_cube_mode_matches_jax():
  _step_both('Dropbox', 'cube')


def _obs(rng, env, near):
  """An obs dict with goals; `near` puts the goal positions within 0.01."""
  fs, gfs = (rng.uniform(-1, 1, env.obs_size).astype(np.float32)
             for _ in range(2))
  if near:
    gfs = fs + rng.uniform(-0.01, 0.01, fs.shape).astype(np.float32)
  idx = np.asarray(env.pobs_idxs)
  lcd = rng.uniform(size=(env.lcd_h, env.lcd_w)) > 0.5
  glcd = lcd.copy() if near else rng.uniform(size=lcd.shape) > 0.5
  return {'full_state': fs, 'proprio': fs[idx], 'lcd': lcd,
          'goal:full_state': gfs, 'goal:proprio': gfs[idx],
          'goal:lcd': glcd}


@pytest.mark.parametrize('wrapper,env_name', [('BodyGoalEnv', 'Luxo'),
                                              ('CubeGoalEnv', 'LuxoCube')])
@pytest.mark.parametrize('G_kw', [{}, {'diff_delt': 1}, {'state_rew': 0}],
                         ids=['plain', 'diff_delt', 'lcd_similarity'])
def test_goal_wrappers_comp_rew_done_match_jax(wrapper, env_name, G_kw):
  G = rl_G(env=env_name, **G_kw)
  jg = getattr(jwrap, wrapper)(boxlcd_tpu.env_map[env_name](G), G)
  tg = getattr(twrap, wrapper)(
      boxlcd_tpu_torch.env_map[env_name](G, device='cpu'), G)
  assert tg.observation_space.spaces.keys() == jg.observation_space.spaces.keys()
  rng = np.random.default_rng(1)
  for near in (False, True, False, True):
    obs, last = _obs(rng, tg, near), _obs(rng, tg, False)
    jg.last_obs, tg.last_obs = last, {k: v.copy() for k, v in last.items()}
    winfo, ginfo = {}, {}
    want = jg.comp_rew_done(obs, winfo)
    got = tg.comp_rew_done({k: v.copy() for k, v in obs.items()}, ginfo)
    assert got == want and ginfo == winfo, (near, got, want)


def test_goal_wrappers_drive_the_port_env():
  G = rl_G(env='LuxoCube')
  env = boxlcd_tpu_torch.env_map['LuxoCube'](G, device='cpu')
  for cls in (twrap.BodyGoalEnv, twrap.CubeGoalEnv):
    genv = cls(env, G)
    genv.seed(0)
    obs = genv.reset()
    assert set(genv.observation_space.spaces) == set(obs)
    assert obs['goal:lcd'].shape == obs['lcd'].shape
    obs, rew, done, info = genv.step(np.zeros(env.act_size, np.float32))
    assert np.isfinite(rew) and rew <= 1.0
    assert ('delta' in info) == (cls is twrap.BodyGoalEnv)   # as in JAX


class _FakeGym:
  """A counter env with gym's API; gymnasium's 5-tuple when `five`."""

  def __init__(self, seed, five):
    self.observation_space = boxlcd_tpu_torch.spaces.Box(-1, 1, (3,))
    self.action_space = boxlcd_tpu_torch.spaces.Box(-1, 1, (2,))
    self.t, self.seed_, self.five = 0, seed, five

  def seed(self, seed=None):
    self.seed_ = seed

  def reset(self):
    self.t = 0
    o = np.full(3, self.seed_, np.float64)
    return (o, {}) if self.five else o

  def step(self, action):
    self.t += 1
    o = np.array([self.t, action[0], self.seed_], np.float64)
    done = self.t >= 2 + self.seed_
    if self.five:
      return o, float(self.t), done, False, {}
    return o, float(self.t), done, {'t': self.t}

  def close(self):
    pass


@pytest.mark.parametrize('five', [False, True], ids=['gym', 'gymnasium'])
def test_sync_vector_env_and_wrapped_gym_match_jax(five):
  def make(mod):
    return mod.SyncVectorEnv(
        [lambda i=i: mod.WrappedGym(_FakeGym(i, five)) for i in range(3)])
  jv, tv = make(jwrap), make(twrap)
  for v in (jv, tv):
    v.seed([0, 1, 2])
  want, got = jv.reset(), tv.reset()
  assert set(got) == {'full_state', 'proprio'}
  assert got['full_state'].dtype == np.float32
  for k in want:
    np.testing.assert_array_equal(got[k], want[k])
  for t in range(4):
    act = np.full((3, 2), t, np.float32)
    w, g = jv.step(act), tv.step(act)
    for k in w[0]:
      np.testing.assert_array_equal(g[0][k], w[0][k])
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(g[2], w[2])
    assert g[3] == w[3]
  got = tv.reset(idxs=[1])
  assert got['full_state'].shape == (1, 3)
  tv.close()
