"""SyncVectorEnv: serial fallback vector env over stateful envs.

The port of boxlcd_tpu's research/wrappers/sync_vector_env.py (reference:
research/wrappers/sync_vector_env.py); numpy only. For debugging /
heterogeneous wrappers; the fast path is wrappers.VecEnv (batched on the
card)."""
from __future__ import annotations

import numpy as np


class SyncVectorEnv:
  def __init__(self, env_fns, G=None):
    self.envs = [fn() for fn in env_fns]
    self.num_envs = len(self.envs)
    self.action_space = self.envs[0].action_space
    self.observation_space = self.envs[0].observation_space

  def seed(self, seeds=None):
    seeds = seeds or range(self.num_envs)
    for env, s in zip(self.envs, seeds):
      env.seed(int(s))

  def reset(self, idxs=None, **kwargs):
    idxs = range(self.num_envs) if idxs is None else np.atleast_1d(idxs)
    obs = None
    all_obs = [None] * self.num_envs
    for i in idxs:
      kw = {k: (v[i] if np.ndim(v) > 1 else v) for k, v in kwargs.items()}
      all_obs[i] = self.envs[i].reset(**kw)
    # fill non-reset slots with current obs via a zero-action peek is wrong;
    # callers resetting a subset should track their own obs (as the reference
    # AsyncVectorEnv contract does)
    got = [o for o in all_obs if o is not None]
    return {k: np.stack([o[k] for o in got]) for k in got[0]}

  def step(self, actions):
    obs, rews, dones, infos = [], [], [], []
    for env, a in zip(self.envs, actions):
      o, r, d, info = env.step(np.asarray(a))
      if d:
        o = env.reset()
      obs.append(o)
      rews.append(r)
      dones.append(d)
      infos.append(info)
    obs = {k: np.stack([o[k] for o in obs]) for k in obs[0]}
    return obs, np.asarray(rews), np.asarray(dones), infos

  def close(self):
    for env in self.envs:
      env.close() if hasattr(env, 'close') else None
