"""ObjectLocalizer: a supervised frame -> object (x, y) regressor, the
learned env's reward net for cube goals (the port of
research/nets/autoencoders/object_localizer.py).

Its targets are the env's `object*:(x|y):p` entries of `full_state`, so it
trains only on an env with an object (UrchinCube, not Urchin, whose list is
empty). `save_frozen` writes `ObjectLocalizer.frozen.pkl`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    SingleStepAE, lcd_hw)
from boxlcd_tpu_torch.research.nets.autoencoders.encoders import (
    ConvTrunk, StateEmbed)
from boxlcd_tpu_torch.research.nets.common import Dense


class ObjLocModule(nn.Module):
  def __init__(self, hidden_size, nfilter, proprio_n, lcd_h, lcd_w):
    super().__init__()
    n = hidden_size
    self.state_embed = StateEmbed(proprio_n, n)
    self.trunk = ConvTrunk(n, nfilter, n, lcd_h, lcd_w)
    self.head1 = Dense(n, n)
    self.head2 = Dense(n, 4)  # mean (2) + log_std (2)

  def forward(self, lcd, proprio):
    """lcd (B, H, W), proprio (B, p) -> (mean, std), each (B, 2)."""
    x = self.trunk(lcd[:, None], self.state_embed(proprio))
    mean, log_std = self.head2(F.relu(self.head1(F.relu(x)))).chunk(2, -1)
    return mean, torch.exp(log_std)


class ObjectLocalizer(SingleStepAE):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.keys = utils.filtlist(env.obs_keys, 'object.*(x|y):p')
    self.idxs = np.array([env.obs_keys.index(x) for x in self.keys], np.int64)
    self._init()

  def build(self):
    G = self.G
    return ObjLocModule(G.hidden_size, G.nfilter, self.proprio_n, *lcd_hw(G))

  def loss_fn(self, batch, gen=None):
    flat = self.prep(batch)
    mean, std = self.module(flat['lcd'], flat['proprio'])
    target = flat['full_state'][..., torch.as_tensor(self.idxs,
                                                     device=mean.device)]
    loss = -dists.Normal(mean, std, independent=False).log_prob(target).mean()
    return loss, {'loss': loss}

  def localize(self, lcd, proprio):
    return self.module(lcd, proprio)[0]

  def encode(self, batch, noise=False, gen=None, flatten=True):
    return self.localize(batch['lcd'], batch['proprio'])

  def decode(self, z):
    raise NotImplementedError('ObjectLocalizer is not generative')

  def sample_z(self, gen, n):
    raise NotImplementedError('ObjectLocalizer is not generative')

  def evaluate(self, writer, batch, itr, arbiter=None):
    return {}
