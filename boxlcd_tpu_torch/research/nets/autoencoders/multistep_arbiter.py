"""MultiStepArbiter: window-level clip encoder -> z(256) + action prediction
(the port of research/nets/autoencoders/multistep_arbiter.py).

The "FVD" feature network and action-predictability probe of the video
models' `evaluate` and the Evaler. Frames stack on the channel axis: a
(B, T, H, W) clip already is an NCHW batch of T channels, so only the
trunk's flatten needs flax's order (`encoders.ConvTrunk`). Saving it also
writes the frozen net (`Net.save_frozen`) that `load_arbiter` loads.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    MultiStepAE, lcd_hw)
from boxlcd_tpu_torch.research.nets.autoencoders.encoders import (
    ConvTrunk, DeconvTrunk)
from boxlcd_tpu_torch.research.nets.common import Dense


class MSArbModule(nn.Module):
  def __init__(self, hidden_size, nfilter, z_size, proprio_n, act_n, window,
               wh_ratio, lcd_h, lcd_w):
    super().__init__()
    n = self.hidden_size = hidden_size
    self.window = window
    self.state_mlp1 = Dense(proprio_n, n)
    self.state_mlp2 = Dense(n, n)
    self.state_mix = Dense(window * n, n)
    self.trunk = ConvTrunk(n, nfilter, z_size, lcd_h, lcd_w,
                           in_channels=window)
    self.deconv = DeconvTrunk(z_size, nfilter, wh_ratio, out_channels=window)
    self.state_d1 = Dense(z_size, n)
    self.state_d2 = Dense(n, window * n)
    self.state_out = Dense(n, proprio_n)
    self.act_d1 = Dense(z_size, n)
    self.act_d2 = Dense(n, (window - 1) * n)
    self.act_out = Dense(n, act_n)

  def enc(self, lcd, proprio):
    """lcd (B, T, H, W); proprio (B, T, P) -> z (B, z_size)."""
    B = proprio.shape[0]
    emb = F.relu(self.state_mlp2(F.relu(self.state_mlp1(proprio))))
    emb = self.state_mix(emb.reshape(B, -1))
    return self.trunk(lcd, emb)

  def dec(self, z):
    """z -> frame logits (B, T, H, W), proprio (B, T, P), actions
    (B, T - 1, A)."""
    B, n = z.shape[0], self.hidden_size
    lcd_logits = self.deconv(z)
    h = F.relu(self.state_d2(F.relu(self.state_d1(z))))
    proprio = self.state_out(h.reshape(B, self.window, n))
    a = F.relu(self.act_d2(F.relu(self.act_d1(z))))
    action = self.act_out(a.reshape(B, self.window - 1, n))
    return lcd_logits, proprio, action

  def forward(self, lcd, proprio):
    return self.dec(self.enc(lcd, proprio))


class MultiStepArbiter(MultiStepAE):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.z_size = 256
    self.act_n = env.act_size
    self._init()

  def build(self):
    G = self.G
    return MSArbModule(G.hidden_size, G.nfilter, self.z_size, self.proprio_n,
                       self.act_n, G.window, G.wh_ratio, *lcd_hw(G))

  def loss_fn(self, batch, gen=None):
    lcd_l, proprio, action = self.module(batch['lcd'], batch['proprio'])
    recon_lcd = -dists.Bernoulli(lcd_l).log_prob(batch['lcd']).mean()
    recon_proprio = -dists.Normal(
        proprio, torch.ones_like(proprio)).log_prob(batch['proprio']).mean() \
        / self.proprio_n
    recon_action = -dists.Normal(
        action, torch.ones_like(action)).log_prob(
            batch['action'][:, :-1]).mean() / self.act_n
    loss = recon_lcd + recon_proprio + recon_action
    return loss, {'loss/recon_total': loss, 'loss/recon_lcd': recon_lcd,
                  'loss/recon_proprio': recon_proprio,
                  'loss/recon_action': recon_action}

  def encode(self, batch, noise=False, gen=None, flatten=True):
    return self.module.enc(batch['lcd'], batch['proprio'])

  def decode(self, z):
    lcd_l, proprio, action = self.module.dec(z)
    return {'lcd': dists.Bernoulli(lcd_l),
            'proprio': dists.Normal(proprio, torch.ones_like(proprio)),
            'action': dists.Normal(action, torch.ones_like(action))}

  def forward_frozen(self, batch):
    """(z, action predictions): the frozen surface the Evaler and the video
    models' `evaluate` read (reference: multistep_arbiter.py:32-44)."""
    z = self.encode(batch)
    return z, self.module.dec(z)[2]

  def sample_z(self, gen, n):
    return torch.randn((n, self.z_size), generator=gen, device=self.device)

  def save(self, direc):
    super().save(direc)
    self.save_frozen(direc)
