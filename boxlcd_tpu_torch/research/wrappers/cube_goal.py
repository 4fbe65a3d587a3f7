"""CubeGoalEnv: goal = settled object position; reward on object-position
delta.

The port of boxlcd_tpu's research/wrappers/cube_goal.py (reference:
research/wrappers/cube_goal.py), over the port's stateful WorldEnv; numpy
only."""
from __future__ import annotations

import copy

import numpy as np

from boxlcd_tpu_torch import spaces, utils


class CubeGoalEnv:
  def __init__(self, env, G):
    self._env = env
    self.SCALE = 2
    self.G = G
    self.keys = utils.filtlist(self._env.obs_keys, 'object.*(x|y):p')
    self.idxs = [self._env.obs_keys.index(x) for x in self.keys]
    rootkeys = utils.filtlist(self._env.obs_keys, '.*root.*(x|y):p')
    self.root_idxs = [self._env.obs_keys.index(x) for x in rootkeys]

  def __getattr__(self, name):
    return getattr(self._env, name)

  def seed(self, *args):
    return self._env.seed(*args)

  @property
  def action_space(self):
    return self._env.action_space

  @property
  def observation_space(self):
    base = self._env.observation_space
    sp = dict(base.spaces)
    sp['goal:lcd'] = sp['lcd']
    sp['goal:proprio'] = sp['proprio']
    sp['goal:object'] = spaces.Box(-1, 1, (2,), np.float32)
    sp['goal:full_state'] = sp['full_state']
    return spaces.Dict(sp)

  def reset(self, *args, **kwargs):
    self.goal = self._env.reset()
    # let the object settle (reference: cube_goal.py:34-36)
    for _ in range(10):
      self.goal = self._env.step(
          np.zeros(self._env.action_space.shape))[0]
    obs = self._env.reset(*args, **kwargs)
    self._attach_goal(obs)
    self.last_obs = copy.deepcopy(obs)
    return obs

  def _attach_goal(self, obs):
    obs['goal:lcd'] = np.array(self.goal['lcd'])
    obs['goal:full_state'] = np.array(self.goal['full_state'])
    obs['goal:proprio'] = np.array(self.goal['proprio'])
    obs['goal:object'] = np.array(self.goal['full_state'][..., self.idxs])

  def comp_rew_done(self, obs, info=None):
    info = {} if info is None else info
    done = False
    delta = np.abs(obs['goal:full_state'][..., self.idxs]
                   - obs['full_state'][..., self.idxs]).mean()
    if self.G.get('diff_delt', 0):
      last = np.abs(obs['goal:full_state'][..., self.idxs]
                    - self.last_obs['full_state'][..., self.idxs]).mean()
      info['last_delta'] = last
      info['delta'] = delta
      rew = -0.05 + 10 * (last - delta)
    else:
      rew = -delta
    if delta < 0.05:
      done = True
      rew += 1.0
      info['success'] = True
    return rew, done

  def step(self, action):
    obs, rew, done, info = self._env.step(action)
    self._attach_goal(obs)
    rew, _done = self.comp_rew_done(obs, info)
    done = done or _done
    rew = rew * self.G.rew_scale
    self.last_obs = copy.deepcopy(obs)
    return obs, rew, done, info

  def render(self, *args, **kwargs):
    return self._env.render(*args, **kwargs)

  def close(self):
    pass
