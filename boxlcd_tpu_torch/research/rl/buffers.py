"""RL buffers (the port of research/rl/buffers.py, kept as its own copy):
vectorized FIFO replay and the GAE(lambda) PPO buffer. Host-side numpy ring
buffers feeding device batches."""
from __future__ import annotations

import numpy as np


def discount_cumsum(x, discount):
  """reference: research/utils.py:323-336."""
  out = np.zeros_like(x)
  run = 0.0
  for t in reversed(range(len(x))):
    run = x[t] + discount * run
    out[t] = run
  return out


class ReplayBuffer:
  """Vectorized FIFO replay with wrap-around store_n
  (reference: buffers.py:61-109)."""

  def __init__(self, obs_keys_shapes, act_dim, size, obs_dtypes=None):
    self.size = size
    self.ptr = 0
    self.count = 0
    dt = obs_dtypes or {}
    self.obs = {k: np.zeros((size, *s), dt.get(k, np.float32))
                for k, s in obs_keys_shapes.items()}
    self.obs2 = {k: np.zeros((size, *s), dt.get(k, np.float32))
                 for k, s in obs_keys_shapes.items()}
    self.act = np.zeros((size, act_dim), np.float32)
    self.rew = np.zeros(size, np.float32)
    self.done = np.zeros(size, np.float32)

  def store_n(self, obs, act, rew, obs2, done):
    n = len(rew)
    idx = (self.ptr + np.arange(n)) % self.size
    for k in self.obs:
      self.obs[k][idx] = obs[k]
      self.obs2[k][idx] = obs2[k]
    self.act[idx] = act
    self.rew[idx] = rew
    self.done[idx] = done
    self.ptr = (self.ptr + n) % self.size
    self.count = min(self.count + n, self.size)

  def sample_batch(self, rng, batch_size):
    idx = rng.randint(0, self.count, batch_size)
    f32 = lambda v: v[idx].astype(np.float32)  # bool lcd storage -> float
    return {'obs': {k: f32(v) for k, v in self.obs.items()},
            'obs2': {k: f32(v) for k, v in self.obs2.items()},
            'act': self.act[idx], 'rew': self.rew[idx],
            'done': self.done[idx]}


class PPOBuffer:
  """Per-env trajectory GAE buffer (reference: buffers.py:111-187)."""

  def __init__(self, obs_keys_shapes, act_dim, num_envs, steps_per_epoch,
               gamma=0.99, lam=0.97):
    T = steps_per_epoch
    self.T, self.B = T, num_envs
    self.gamma, self.lam = gamma, lam
    self.obs = {k: np.zeros((T, num_envs, *s), np.float32)
                for k, s in obs_keys_shapes.items()}
    self.act = np.zeros((T, num_envs, act_dim), np.float32)
    self.rew = np.zeros((T, num_envs), np.float32)
    self.val = np.zeros((T, num_envs), np.float32)
    self.logp = np.zeros((T, num_envs), np.float32)
    self.adv = np.zeros((T, num_envs), np.float32)
    self.ret = np.zeros((T, num_envs), np.float32)
    self.ptr = 0
    self.path_start = np.zeros(num_envs, np.int64)

  def store_n(self, obs, act, rew, val, logp):
    t = self.ptr
    for k in self.obs:
      self.obs[k][t] = obs[k]
    self.act[t] = act
    self.rew[t] = rew
    self.val[t] = val
    self.logp[t] = logp
    self.ptr += 1

  def finish_path(self, env_i, last_val):
    """GAE + rewards-to-go for one env's open path
    (reference: buffers.py:140-170)."""
    s, t = self.path_start[env_i], self.ptr
    rews = np.append(self.rew[s:t, env_i], last_val)
    vals = np.append(self.val[s:t, env_i], last_val)
    deltas = rews[:-1] + self.gamma * vals[1:] - vals[:-1]
    self.adv[s:t, env_i] = discount_cumsum(deltas, self.gamma * self.lam)
    self.ret[s:t, env_i] = discount_cumsum(rews, self.gamma)[:-1]
    self.path_start[env_i] = t

  def get(self):
    assert self.ptr == self.T
    adv = self.adv.reshape(-1)
    adv = (adv - adv.mean()) / max(adv.std(), 1e-8)
    data = {'obs': {k: v.reshape(-1, *v.shape[2:]) for k, v in self.obs.items()},
            'act': self.act.reshape(-1, self.act.shape[-1]),
            'ret': self.ret.reshape(-1), 'adv': adv,
            'logp': self.logp.reshape(-1)}
    self.ptr = 0
    self.path_start[:] = 0
    return data
