"""VAE: conv encoder -> Normal(128) -> deconv decoder, beta-KL (the port of
research/nets/autoencoders/vae.py)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    SingleStepAE, flat01, lcd_hw)
from boxlcd_tpu_torch.research.nets.autoencoders.encoders import (
    ConvTrunk, DeconvTrunk, StateEmbed, StateHead)


class VAEModule(nn.Module):
  def __init__(self, hidden_size, nfilter, z_size, proprio_n, wh_ratio,
               lcd_h, lcd_w):
    super().__init__()
    n = hidden_size
    self.state_embed = StateEmbed(proprio_n, n)
    self.trunk = ConvTrunk(n, nfilter, 2 * z_size, lcd_h, lcd_w)
    self.deconv = DeconvTrunk(z_size, nfilter, wh_ratio)
    self.state_head = StateHead(z_size, n, proprio_n)

  def enc(self, lcd, proprio):
    """lcd (B, H, W), proprio (B, p) -> the posterior Normal over z."""
    out = self.trunk(lcd[:, None], self.state_embed(proprio))
    mu, log_std = out.chunk(2, -1)
    return dists.Normal(mu, F.softplus(log_std) + 1e-4, independent=False)

  def dec(self, z):
    state = self.state_head(z)
    return {'lcd': dists.Bernoulli(self.deconv(z)[:, 0]),
            'proprio': dists.Normal(state, torch.ones_like(state))}

  def forward(self, lcd, proprio):
    return self.dec(self.enc(lcd, proprio).mean)


class VAE(SingleStepAE):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.z_size = 128
    self._init()

  def build(self):
    G = self.G
    return VAEModule(G.hidden_size, G.nfilter, self.z_size, self.proprio_n,
                     G.wh_ratio, *lcd_hw(G))

  def loss_fn(self, batch, gen=None, eps=None):
    """The posterior sample's normals come from `gen` unless given as eps
    (z's shape, (B*T, z_size))."""
    flat = self.prep(batch)
    post = self.module.enc(flat['lcd'], flat['proprio'])
    z = post.sample(gen, eps=eps)
    dec = self.module.dec(z)
    recon_lcd = -dec['lcd'].log_prob(flat['lcd']).mean()
    recon_proprio = -dec['proprio'].log_prob(flat['proprio']).mean() \
        / self.proprio_n
    recon = recon_lcd + recon_proprio
    prior = dists.Normal(torch.zeros_like(post.mean),
                         torch.ones_like(post.std), independent=False)
    kl = post.kl(prior).mean()
    loss = recon + self.G.beta * kl
    return loss, {'loss/vae_loss': loss, 'loss/kl': kl,
                  'loss/recon_total': recon, 'loss/recon_lcd': recon_lcd,
                  'loss/recon_proprio': recon_proprio}

  def encode(self, batch, noise=False, gen=None, flatten=True):
    lcd, proprio = batch['lcd'], batch['proprio']
    shape = lcd.shape
    if lcd.dim() == 4:
      lcd, proprio = flat01(lcd), flat01(proprio)
    post = self.module.enc(lcd, proprio)
    z = post.sample(gen) if noise and gen is not None else post.mean
    if len(shape) == 4:
      z = z.reshape(shape[0], shape[1], -1)
    return z

  def decode(self, z):
    return self.module.dec(z)

  def sample_z(self, gen, n):
    return torch.randn((n, self.z_size), generator=gen, device=self.device)
