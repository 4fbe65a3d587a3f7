"""ArbiterAE: a plain autoencoder whose frozen encoder is the FID feature
net of the autoencoders' `evaluate` (the port of
research/nets/autoencoders/arbiter.py). Saving it also writes the frozen
net (`Net.save_frozen`) that `runners/trainer.load_arbiter` loads."""
from __future__ import annotations

import torch
import torch.nn as nn

from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    SingleStepAE, lcd_hw)
from boxlcd_tpu_torch.research.nets.autoencoders.encoders import (
    ConvTrunk, DeconvTrunk, StateEmbed, StateHead)


class ArbiterModule(nn.Module):
  def __init__(self, hidden_size, nfilter, z_size, proprio_n, wh_ratio,
               lcd_h, lcd_w):
    super().__init__()
    n = hidden_size
    self.state_embed = StateEmbed(proprio_n, n)
    self.trunk = ConvTrunk(n, nfilter, z_size, lcd_h, lcd_w)
    self.deconv = DeconvTrunk(z_size, nfilter, wh_ratio)
    self.state_head = StateHead(z_size, n, proprio_n)

  def enc(self, lcd, proprio):
    """lcd (B, H, W), proprio (B, p) -> z (B, z_size)."""
    return self.trunk(lcd[:, None], self.state_embed(proprio))

  def dec(self, z):
    state = self.state_head(z)
    return {'lcd': dists.Bernoulli(self.deconv(z)[:, 0]),
            'proprio': dists.Normal(state, torch.ones_like(state))}

  def forward(self, lcd, proprio):
    return self.dec(self.enc(lcd, proprio))


class ArbiterAE(SingleStepAE):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.z_size = 128
    self._init()

  def build(self):
    G = self.G
    return ArbiterModule(G.hidden_size, G.nfilter, self.z_size,
                         self.proprio_n, G.wh_ratio, *lcd_hw(G))

  def loss_fn(self, batch, gen=None):
    flat = self.prep(batch)
    dec = self.module(flat['lcd'], flat['proprio'])
    recon_lcd = -dec['lcd'].log_prob(flat['lcd']).mean()
    recon_proprio = -dec['proprio'].log_prob(flat['proprio']).mean() \
        / self.proprio_n
    loss = recon_lcd + recon_proprio
    return loss, {'loss/recon_total': loss, 'loss/recon_lcd': recon_lcd,
                  'loss/recon_proprio': recon_proprio}

  def encode(self, batch, noise=False, gen=None, flatten=True):
    return self.module.enc(batch['lcd'], batch['proprio'])

  def decode(self, z):
    return self.module.dec(z)

  def sample_z(self, gen, n):
    return torch.randn((n, self.z_size), generator=gen, device=self.device)

  def save(self, direc):
    # every checkpoint refreshes the frozen feature net (the JAX package's
    # arbiter save is its trace dump)
    super().save(direc)
    self.save_frozen(direc)
