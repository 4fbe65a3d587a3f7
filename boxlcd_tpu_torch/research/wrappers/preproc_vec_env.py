"""PreprocVecEnv: encode observations through a frozen autoencoder, adding
zstate / goal:zstate (the port of research/wrappers/preproc_vec_env.py).

It wraps a vector env, the real one (numpy observations, `VecEnv`) or the
learned one (tensors on the device, `RewardLenv`/`LearnedEnv`), and each
observation keeps the type the wrapped env gives: zstate is a numpy array
beside numpy observations and a tensor on the model's device beside
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from boxlcd_tpu_torch import spaces


class PreprocVecEnv:
  def __init__(self, model, env, G):
    self.model = model
    self._env = env
    self.G = G
    self.z_size = model.z_size

  def __getattr__(self, name):
    return getattr(self._env, name)

  @property
  def num_envs(self):
    return self._env.num_envs

  @property
  def action_space(self):
    return self._env.action_space

  @property
  def observation_space(self):
    sp = dict(self._env.observation_space.spaces)
    sp['zstate'] = spaces.Box(-1, 1, (self.z_size,), np.float32)
    if 'goal:lcd' in sp:
      sp['goal:zstate'] = spaces.Box(-1, 1, (self.z_size,), np.float32)
    return spaces.Dict(sp)

  @torch.no_grad()
  def _encode(self, lcd, proprio):
    dev = self.model.device
    z = self.model.encode(
        {'lcd': torch.as_tensor(lcd, device=dev).float(),
         'proprio': torch.as_tensor(proprio, device=dev).float()},
        noise=False)
    return z if isinstance(lcd, torch.Tensor) else z.cpu().numpy()

  def _preproc(self, obs):
    obs['zstate'] = self._encode(obs['lcd'], obs['proprio'])
    if 'goal:lcd' in obs:
      obs['goal:zstate'] = self._encode(obs['goal:lcd'], obs['goal:proprio'])
    return obs

  def reset(self, *args, **kwargs):
    return self._preproc(dict(self._env.reset(*args, **kwargs)))

  def step(self, action):
    obs, rew, done, info = self._env.step(action)
    return self._preproc(dict(obs)), rew, done, info
