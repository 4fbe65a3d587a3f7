"""RNLDA: the BVAE's module with the 4-level number-line quantizer (the port
of research/nets/autoencoders/rnlda.py)."""
from __future__ import annotations

import torch

from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    SingleStepAE, flat01)
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAEModule
from boxlcd_tpu_torch.research.nets.quantize import rnld

CENTERS = (-0.75, -0.25, 0.25, 0.75)


class RNLDA(SingleStepAE):
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
    """The quantizer's uniforms come from `gen` unless given as u (the z
    logits' shape, (B*T, zH, zW, vqD))."""
    flat = self.prep(batch)
    z_e = self.module.enc(flat['lcd'], flat['proprio'])
    z_q, idxs = rnld(z_e, gen, noise=True, u=u)
    dec = self.module.dec(z_q)
    recon_lcd = -dec['lcd'].log_prob(flat['lcd']).mean()
    recon_proprio = -dec['proprio'].log_prob(flat['proprio']).mean() \
        / self.proprio_n
    loss = recon_lcd + recon_proprio
    metrics = {'loss/total': loss, 'loss/recon_total': loss,
               'loss/recon_lcd': recon_lcd,
               'loss/recon_proprio': recon_proprio}
    for k in range(4):
      metrics[f'idx{k}_frac'] = (idxs == k).float().mean()
    return loss, metrics

  def encode(self, batch, noise=False, gen=None, flatten=True,
             quantize=True):
    lcd, proprio = batch['lcd'], batch['proprio']
    shape = lcd.shape
    if lcd.dim() == 4:
      lcd, proprio = flat01(lcd), flat01(proprio)
    z_e = self.module.enc(lcd, proprio)
    if quantize:
      z_e, _ = rnld(z_e, gen, noise=noise)
    if flatten:
      z_e = z_e.reshape(z_e.shape[0], -1)
    if len(shape) == 4:
      z_e = z_e.reshape(shape[0], shape[1], *z_e.shape[1:])
    return z_e

  def unflatten_z(self, z):
    return z.reshape(-1, self.zH, self.zW, self.G.vqD)

  def decode(self, z):
    if z.dim() == 2:
      z = self.unflatten_z(z)
    return self.module.dec(z)

  def sample_z(self, gen, n):
    """Uniform over the 4 bin centers."""
    idx = torch.randint(0, 4, (n, self.zH, self.zW, self.G.vqD),
                        generator=gen, device=self.device)
    return torch.tensor(CENTERS, device=self.device)[idx]
