"""BodyGoalEnv: goal-conditioned wrapper — goal is a second env reset snapshot.

The port of boxlcd_tpu's research/wrappers/body_goal.py (reference:
research/wrappers/body_goal.py), over the port's stateful WorldEnv; numpy
only."""
from __future__ import annotations

import copy

import numpy as np

from boxlcd_tpu_torch import spaces, utils


class BodyGoalEnv:
  def __init__(self, env, G):
    self._env = env
    self.SCALE = 2
    self.G = G
    keys = utils.filtlist(self._env.pobs_keys, '.*(x|y):p')
    self.idxs = [self._env.pobs_keys.index(x) for x in keys]

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
    return spaces.Dict(sp)

  def reset(self, *args, **kwargs):
    self.goal = self._env.reset()
    obs = self._env.reset(*args, **kwargs)
    obs['goal:lcd'] = np.array(self.goal['lcd'])
    obs['goal:proprio'] = np.array(self.goal['proprio'])
    self.last_obs = copy.deepcopy(obs)
    return obs

  def comp_rew_done(self, obs, info=None):
    """Negative mean |Δ(x,y)| over proprio position keys; +1 success bonus at
    goal_thresh (reference: body_goal.py:58-88)."""
    info = {} if info is None else info
    done = False
    if self.G.state_rew:
      delta = np.abs(obs['goal:proprio'] - obs['proprio'])
      delta = delta[self.idxs].mean()
      if self.G.get('diff_delt', 0):
        last = np.abs(self.last_obs['goal:proprio'] - self.last_obs['proprio'])
        rew = -0.05 + 10 * (last[self.idxs].mean() - delta)
      else:
        rew = -delta
      info['delta'] = delta
      if delta < self.G.goal_thresh:
        rew += 1.0
        info['success'] = True
        done = True
    else:
      lcd, glcd = obs['lcd'], obs['goal:lcd']
      on = (lcd == 0).mean()
      similarity = (np.logical_and(lcd == 0, lcd == glcd).mean()
                    / max(on, 1e-8))
      rew = -1 + similarity
      info['delta'] = similarity
      if similarity > 0.70:
        rew = 0
        info['success'] = True
        done = True
    return rew, done

  def step(self, action):
    obs, rew, done, info = self._env.step(action)
    obs['goal:lcd'] = np.array(self.goal['lcd'])
    obs['goal:proprio'] = np.array(self.goal['proprio'])
    rew, _done = self.comp_rew_done(obs, info)
    done = done or _done
    rew = rew * self.G.rew_scale
    self.last_obs = copy.deepcopy(obs)
    return obs, rew, done, info

  def render(self, *args, **kwargs):
    return self._env.render(*args, **kwargs)

  def close(self):
    pass
