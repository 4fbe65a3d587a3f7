"""RL networks in torch (the port of research/rl/nets.py): the PPO Gaussian
actor-critic and the SAC squashed-Gaussian actor + twin Q.

Submodule attribute names are the flax parameter-tree names (`pi`, `v`,
`goal_preproc`, `BaseMLP_0`, `SACFeatures_0`, `ImgCNN_0`, `Dense_<i>`, ...)
and PPOActor's `log_std` is a raw parameter as in flax, so
`convert.load_flax` carries a flax tree over by name. flax infers a Dense's
input size from its first call; here the sizes come from the constructor
(`goal_size`, `lcd_shape`, `z_size` beside JAX's `state_size`).

Where JAX draws a normal from a key, the port's function takes a
`torch.Generator` (`gen`) and, optionally, the normals themselves (`eps`):
a test feeds JAX's draws as values.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch.research.nets.common import Conv, Dense

LOG_STD_MAX = 2
LOG_STD_MIN = -20


class BaseMLP(nn.Module):
  def __init__(self, in_size, out_size, hidden_size=128):
    super().__init__()
    self.Dense_0 = Dense(in_size, hidden_size)
    self.Dense_1 = Dense(hidden_size, hidden_size)
    self.Dense_2 = Dense(hidden_size, out_size)

  def forward(self, x):
    x = F.relu(self.Dense_0(x))
    x = F.relu(self.Dense_1(x))
    return self.Dense_2(x)


class PPOActor(nn.Module):
  """Gaussian policy over [state_key, linear(goal)]
  (reference: pponets.py:36-70)."""

  def __init__(self, act_dim, state_key, goal_key, state_size, goal_size,
               hidden_size=128):
    super().__init__()
    self.state_key, self.goal_key = state_key, goal_key
    self.log_std = nn.Parameter(-0.5 * torch.ones(act_dim))
    self.goal_preproc = Dense(goal_size, state_size)
    self.BaseMLP_0 = BaseMLP(2 * state_size, act_dim, hidden_size)

  def forward(self, obs):
    x = torch.cat([obs[self.state_key],
                   self.goal_preproc(obs[self.goal_key])], -1)
    return self.BaseMLP_0(x), torch.exp(self.log_std)


class PPOCritic(nn.Module):
  def __init__(self, state_key, goal_key, state_size, goal_size,
               hidden_size=128):
    super().__init__()
    self.state_key, self.goal_key = state_key, goal_key
    self.goal_preproc = Dense(goal_size, state_size)
    self.BaseMLP_0 = BaseMLP(2 * state_size, 1, hidden_size)

  def forward(self, obs):
    x = torch.cat([obs[self.state_key],
                   self.goal_preproc(obs[self.goal_key])], -1)
    return self.BaseMLP_0(x)[..., 0]


class PPOActorCritic(nn.Module):
  def __init__(self, act_dim, state_key, goal_key, state_size, goal_size,
               hidden_size=128):
    super().__init__()
    self.pi = PPOActor(act_dim, state_key, goal_key, state_size, goal_size,
                       hidden_size)
    self.v = PPOCritic(state_key, goal_key, state_size, goal_size,
                       hidden_size)

  def forward(self, obs):
    mu, std = self.pi(obs)
    return mu, std, self.v(obs)

  def policy(self, obs):
    return self.pi(obs)

  def value(self, obs):
    return self.v(obs)


def gaussian_logp(mu, std, act):
  lp = -0.5 * (((act - mu) / std) ** 2 + 2 * torch.log(std)
               + math.log(2 * math.pi))
  return lp.sum(-1)


def _same_out(n, times=3):
  """A size after `times` stride-2 'SAME' convolutions."""
  for _ in range(times):
    n = -(-n // 2)
  return n


class ImgCNN(nn.Module):
  """Conv trunk over a single-channel frame (reference: sacnets.py:31-58).
  The features flatten in flax's (h, w, c) order, so the next Dense's
  carried-over kernel lines up."""

  def __init__(self, nfilter):
    super().__init__()
    self.Conv_0 = Conv(1, nfilter, 3, 2)
    self.Conv_1 = Conv(nfilter, nfilter, 3, 2)
    self.Conv_2 = Conv(nfilter, nfilter, 3, 2)

  @staticmethod
  def out_size(nfilter, lcd_shape):
    return nfilter * _same_out(lcd_shape[0]) * _same_out(lcd_shape[1])

  def forward(self, img):
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    x = F.relu(self.Conv_0(x))
    x = F.relu(self.Conv_1(x))
    x = self.Conv_2(x)
    return x.permute(0, 2, 3, 1).reshape(*lead, -1)


class ImgMLP(nn.Module):
  """MLP trunk over a flattened frame (reference: sacnets.py:73-98
  BaseCMLP)."""

  def __init__(self, in_size, hidden_size):
    super().__init__()
    self.Dense_0 = Dense(in_size, hidden_size)
    self.Dense_1 = Dense(hidden_size, hidden_size)
    self.Dense_2 = Dense(hidden_size, hidden_size)

  def forward(self, img):
    x = img.reshape(*img.shape[:-2], -1)
    x = F.relu(self.Dense_0(x))
    x = F.relu(self.Dense_1(x))
    return self.Dense_2(x)


class SACFeatures(nn.Module):
  """obs -> features per `net` variant (reference: sacnets.py:31-127).

  'mlp'  — compact state + goal vector;
  'cmlp' — per-frame MLP over lcd and goal:lcd, goal-delta (g - s) features;
  'cnn'  — conv trunk over lcd and goal:lcd, goal-delta features, plus the
           compact goal and proprio (reference: sacnets.py:63-71);
  'bvae' — frozen-encoder zstate from PreprocVecEnv + compact goal
           (reference: sacnets.py:141-152).
  `size` is the features' width.
  """

  def __init__(self, net, state_key, goal_key, hidden_size, state_size,
               goal_size, nfilter=64, zdelta=True, lcd_shape=None,
               z_size=None):
    super().__init__()
    self.net, self.state_key, self.goal_key = net, state_key, goal_key
    self.zdelta = zdelta
    pair = 1 if zdelta else 2
    if net == 'mlp':
      self.size = state_size + goal_size
    elif net == 'cmlp':
      self.ImgMLP_0 = ImgMLP(lcd_shape[0] * lcd_shape[1], hidden_size)
      self.Dense_0 = Dense(pair * hidden_size, hidden_size)
      self.size = hidden_size
    elif net == 'cnn':
      self.ImgCNN_0 = ImgCNN(nfilter)
      n = pair * ImgCNN.out_size(nfilter, lcd_shape) + goal_size + state_size
      self.Dense_0 = Dense(n, hidden_size)
      self.Dense_1 = Dense(hidden_size, hidden_size)
      self.Dense_2 = Dense(hidden_size, hidden_size)
      self.size = hidden_size
    elif net == 'bvae':
      self.Dense_0 = Dense(z_size, hidden_size)
      self.size = hidden_size + goal_size
    else:
      raise ValueError(f'unknown SAC net variant: {net}')

  def forward(self, obs):
    if self.net == 'mlp':
      return torch.cat([obs[self.state_key], obs[self.goal_key]], -1)
    if self.net == 'bvae':
      return torch.cat([self.Dense_0(obs['zstate']), obs[self.goal_key]], -1)
    trunk = self.ImgMLP_0 if self.net == 'cmlp' else self.ImgCNN_0
    s, g = trunk(obs['lcd']), trunk(obs['goal:lcd'])
    x = g - s if self.zdelta else torch.cat([s, g], -1)
    if self.net == 'cmlp':
      return self.Dense_0(x)
    x = torch.cat([x, obs[self.goal_key], obs[self.state_key]], -1)
    h = F.relu(self.Dense_0(x))
    h = F.relu(self.Dense_1(h))
    return self.Dense_2(h)


class SACActor(nn.Module):
  """Squashed-Gaussian actor (reference: sacnets.py:160-234)."""

  def __init__(self, act_dim, features, hidden_size=128):
    super().__init__()
    self.mlp = features.net == 'mlp'
    self.SACFeatures_0 = features
    layers = [Dense(features.size, hidden_size)]
    if self.mlp:
      layers.append(Dense(hidden_size, hidden_size))
    layers += [Dense(hidden_size, act_dim), Dense(hidden_size, act_dim)]
    for i, layer in enumerate(layers):
      setattr(self, f'Dense_{i}', layer)
    self.n_hidden = 2 if self.mlp else 1

  def forward(self, obs, gen=None, deterministic=False, eps=None):
    """(tanh action, its log-prob). The pre-squash action is the mean when
    deterministic or with neither `gen` nor `eps` (JAX: no key), else mean
    + std * eps, eps drawn from `gen` unless given."""
    h = self.SACFeatures_0(obs)
    for i in range(self.n_hidden):
      h = F.relu(getattr(self, f'Dense_{i}')(h))
    mu = getattr(self, f'Dense_{self.n_hidden}')(h)
    log_std = torch.clamp(getattr(self, f'Dense_{self.n_hidden + 1}')(h),
                          LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    if deterministic or (gen is None and eps is None):
      pre = mu
    else:
      if eps is None:
        eps = torch.randn(mu.shape, generator=gen, device=mu.device)
      pre = mu + std * eps
    logp = gaussian_logp(mu, std, pre)
    # tanh correction (SAC paper appendix)
    logp = logp - (2 * (math.log(2.0) - pre - F.softplus(-2 * pre))).sum(-1)
    return torch.tanh(pre), logp


class SACQ(nn.Module):
  """Twin-Q head (reference: sacnets.py:115-158)."""

  def __init__(self, act_dim, features, hidden_size=128):
    super().__init__()
    self.mlp = features.net == 'mlp'
    self.SACFeatures_0 = features
    if self.mlp:
      self.BaseMLP_0 = BaseMLP(features.size + act_dim, 1, hidden_size)
    else:
      self.Dense_0 = Dense(act_dim, hidden_size)
      self.Dense_1 = Dense(features.size + hidden_size, hidden_size)
      self.Dense_2 = Dense(hidden_size, 1)

  def forward(self, obs, act):
    feats = self.SACFeatures_0(obs)
    if self.mlp:
      return self.BaseMLP_0(torch.cat([feats, act], -1))[..., 0]
    x = torch.cat([feats, self.Dense_0(act)], -1)
    return self.Dense_2(F.relu(self.Dense_1(x)))[..., 0]


class SACNets(nn.Module):
  def __init__(self, act_dim, state_key, goal_key, state_size, goal_size,
               hidden_size=128, net='mlp', nfilter=64, zdelta=True,
               lcd_shape=None, z_size=None):
    super().__init__()
    feats = lambda: SACFeatures(net, state_key, goal_key, hidden_size,
                                state_size, goal_size, nfilter, zdelta,
                                lcd_shape, z_size)
    self.pi = SACActor(act_dim, feats(), hidden_size)
    self.q1 = SACQ(act_dim, feats(), hidden_size)
    self.q2 = SACQ(act_dim, feats(), hidden_size)

  def forward(self, obs, act, gen=None, eps=None):
    a, logp = self.pi(obs, gen, eps=eps)
    return a, logp, self.q1(obs, act), self.q2(obs, act)

  def actor(self, obs, gen=None, deterministic=False, eps=None):
    return self.pi(obs, gen, deterministic, eps)

  def qs(self, obs, act):
    return self.q1(obs, act), self.q2(obs, act)
