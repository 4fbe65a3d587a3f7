"""WrappedGym: adapt a standard gym env into the dict-obs protocol.

The port of boxlcd_tpu's research/wrappers/wrapped_gym.py (reference:
research/wrappers/wrapped_gym.py); numpy only. It takes any object with
gym's (or gymnasium's) reset/step API; gym itself is not a dependency."""
from __future__ import annotations

import numpy as np

from boxlcd_tpu_torch import spaces


class WrappedGym:
  def __init__(self, env, G=None):
    self._env = env
    self.G = G
    obs_space = env.observation_space
    self.observation_space = spaces.Dict({
        'full_state': spaces.Box(-np.inf, np.inf, obs_space.shape, np.float32),
        'proprio': spaces.Box(-np.inf, np.inf, obs_space.shape, np.float32),
    })
    self.action_space = env.action_space

  def seed(self, seed=None):
    if hasattr(self._env, 'seed'):
      return self._env.seed(seed)

  def _obs(self, o):
    o = np.asarray(o, np.float32)
    return {'full_state': o, 'proprio': o}

  def reset(self, *args, **kwargs):
    out = self._env.reset()
    obs = out[0] if isinstance(out, tuple) else out
    return self._obs(obs)

  def step(self, action):
    out = self._env.step(action)
    if len(out) == 5:  # gymnasium API
      o, r, term, trunc, info = out
      done = term or trunc
      info = dict(info, timeout=trunc)
    else:
      o, r, done, info = out
    return self._obs(o), r, done, info

  def render(self, *args, **kwargs):
    return self._env.render(*args, **kwargs)

  def close(self):
    self._env.close()
