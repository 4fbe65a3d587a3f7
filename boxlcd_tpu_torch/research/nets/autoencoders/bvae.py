"""BVAE: conv encoder -> binary latent -> conv decoder (the port of
research/nets/autoencoders/bvae.py).

The key encoder for the FBT world model. The latent is a (zH, zW, vqD)
grid of straight-through Bernoulli bits; the loss is Bernoulli/Gaussian
recon minus an entropy bonus. The convolutions run NCHW inside, but the
public z keeps the JAX layout: (B, zH, zW, vqD), flattened in C order over
(zH, zW, vqD), so FBT tokens and packed latents are the same bits in both
packages.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    SingleStepAE, flat01)
from boxlcd_tpu_torch.research.nets.common import (
    Conv, Dense, ResBlock, Upsample)
from boxlcd_tpu_torch.research.nets.quantize import binary_quantize


class Encoder(nn.Module):
  """(reference: bvae.py:60-93) proprio-conditioned conv downsampler."""

  def __init__(self, hidden_size, nfilter, vqD, proprio_n):
    super().__init__()
    n, nf = hidden_size, nfilter
    self.Dense_0 = Dense(proprio_n, n)
    self.Dense_1 = Dense(n, n)
    self.Dense_2 = Dense(n, n)
    self.Conv_0 = Conv(1, nf, 3)
    self.ResBlock_0 = ResBlock(nf, n, group_size=4)
    self.Conv_1 = Conv(nf, nf, 3, stride=2)
    self.ResBlock_1 = ResBlock(nf, n, group_size=4)
    self.Conv_2 = Conv(nf, nf, 3, stride=2)
    self.ResBlock_2 = ResBlock(nf, n, group_size=4)
    self.Conv_3 = Conv(nf, vqD, 1)

  def forward(self, lcd, proprio):
    """lcd (B, H, W), proprio (B, p) -> z logits (B, zH, zW, vqD)."""
    emb = F.relu(self.Dense_1(F.relu(self.Dense_0(proprio))))
    emb = self.Dense_2(emb)
    x = self.Conv_0(lcd[:, None])
    x = self.ResBlock_0(x, emb)
    x = self.ResBlock_1(self.Conv_1(x), emb)
    x = self.ResBlock_2(self.Conv_2(x), emb)
    return self.Conv_3(x).permute(0, 2, 3, 1)


class Decoder(nn.Module):
  """(reference: bvae.py:105-134) latent grid -> lcd Bernoulli + proprio Normal."""

  def __init__(self, hidden_size, nfilter, proprio_n, z_size, vqD):
    super().__init__()
    n, nf = hidden_size, nfilter
    self.Dense_0 = Dense(z_size, n)
    self.Dense_1 = Dense(n, n)
    self.Dense_2 = Dense(n, proprio_n)
    self.Upsample_0 = Upsample(vqD, nf)
    self.Upsample_1 = Upsample(nf, nf)
    self.Conv_0 = Conv(nf, nf, 3)
    self.Conv_1 = Conv(nf, 1, 3)

  def forward(self, z):
    """z (B, zH, zW, vqD) -> {'lcd': Bernoulli (B, H, W), 'proprio': Normal}."""
    h = z.reshape(z.shape[0], -1)                       # (zH, zW, vqD) order
    h = F.relu(self.Dense_1(F.relu(self.Dense_0(h))))
    state = self.Dense_2(h)
    x = F.relu(self.Upsample_0(z.permute(0, 3, 1, 2)))
    x = F.relu(self.Upsample_1(x))
    x = F.relu(self.Conv_0(x))
    x = self.Conv_1(x)[:, 0]                            # (B, H, W)
    return {'lcd': dists.Bernoulli(x),
            'proprio': dists.Normal(state, torch.ones_like(state))}


class BVAEModule(nn.Module):
  def __init__(self, hidden_size, nfilter, vqD, proprio_n, zH, zW):
    super().__init__()
    self.encoder = Encoder(hidden_size, nfilter, vqD, proprio_n)
    self.decoder = Decoder(hidden_size, nfilter, proprio_n, zH * zW * vqD,
                           vqD)

  def forward(self, lcd, proprio):
    return self.decoder(torch.sigmoid(self.encoder(lcd, proprio)))

  def enc(self, lcd, proprio):
    return self.encoder(lcd, proprio)

  def dec(self, z):
    return self.decoder(z)


class BVAE(SingleStepAE):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.zH = 4
    self.zW = int(G.wh_ratio * self.zH)
    self.z_size = self.zH * self.zW * G.vqD
    self._init()

  def build(self):
    G = self.G
    return BVAEModule(G.hidden_size, G.nfilter, G.vqD, self.proprio_n,
                      self.zH, self.zW)

  def loss_fn(self, batch, gen=None, u=None):
    """(reference: bvae.py:27-39). The quantizer's uniforms come from `gen`
    unless given as u (the z logits' shape, (B*T, zH, zW, vqD))."""
    flat = self.prep(batch)
    z_e = self.module.enc(flat['lcd'], flat['proprio']).float()
    z_q, entropy, probs = binary_quantize(z_e, gen, noise=True, u=u)
    dec = self.module.dec(z_q)
    lcd_logits = dec['lcd'].logits.float()
    recon_lcd = -dists.Bernoulli(lcd_logits).log_prob(flat['lcd']).mean()
    mu = dec['proprio'].mean.float()
    recon_proprio = -dists.Normal(mu, torch.ones_like(mu)).log_prob(
        flat['proprio']).mean() / self.proprio_n  # elementwise mean
    recon = recon_lcd + recon_proprio
    loss = recon - self.G.entropy_bonus * entropy
    return loss, {'loss/total': loss, 'loss/entropy': entropy,
                  'loss/recon_lcd': recon_lcd,
                  'loss/recon_proprio': recon_proprio,
                  'loss/recon_total': recon,
                  'bvae_abs_probs': torch.abs(probs - 0.5).mean()}

  # -- AE surface ---------------------------------------------------------------
  def encode(self, batch, noise=False, gen=None, flatten=True):
    """batch lcd (B,H,W) or (B,T,H,W) -> binary z (reference: bvae.py:41-54)."""
    lcd, proprio = batch['lcd'], batch['proprio']
    shape = lcd.shape
    if lcd.dim() == 4:
      lcd, proprio = flat01(lcd), flat01(proprio)
    z_e = self.module.enc(lcd, proprio).float()
    z_q, _, _ = binary_quantize(z_e, gen, noise=noise)
    if flatten:
      z_q = z_q.reshape(z_q.shape[0], -1)
    if len(shape) == 4:
      z_q = z_q.reshape(shape[0], shape[1], *z_q.shape[1:])
    return z_q

  def unflatten_z(self, z):
    return z.reshape(-1, self.zH, self.zW, self.G.vqD)

  def decode(self, z):
    if z.dim() == 2:
      z = self.unflatten_z(z)
    return self.module.dec(z)

  def sample_z(self, gen, n):
    return (torch.rand((n, self.zH, self.zW, self.G.vqD), generator=gen,
                       device=self.device) < 0.5).float()
