"""VQ-VAE with a classic codebook (the port of
research/nets/autoencoders/vqvae.py): the BVAE's Encoder and Decoder around
`quantize.VectorQuantizer`."""
from __future__ import annotations

import torch
import torch.nn as nn

from boxlcd_tpu_torch.research.nets.autoencoders._base import SingleStepAE
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import Decoder, Encoder
from boxlcd_tpu_torch.research.nets.quantize import VectorQuantizer


class VQVAEModule(nn.Module):
  def __init__(self, hidden_size, nfilter, vqD, vqK, beta, proprio_n, zH,
               zW):
    super().__init__()
    self.encoder = Encoder(hidden_size, nfilter, vqD, proprio_n)
    self.vq = VectorQuantizer(vqK, vqD, beta)
    self.decoder = Decoder(hidden_size, nfilter, proprio_n, zH * zW * vqD,
                           vqD)

  def forward(self, lcd, proprio):
    vq_loss, z_q, perplexity, _ = self.vq(self.encoder(lcd, proprio))
    return self.decoder(z_q), vq_loss, perplexity

  def enc(self, lcd, proprio):
    return self.vq(self.encoder(lcd, proprio))[1]

  def dec(self, z):
    return self.decoder(z)


class VQVAE(SingleStepAE):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.zH = 4
    self.zW = int(G.wh_ratio * self.zH)
    self.z_size = self.zH * self.zW * G.vqD
    self._init()

  def build(self):
    G = self.G
    return VQVAEModule(G.hidden_size, G.nfilter, G.vqD, G.vqK, G.beta,
                       self.proprio_n, self.zH, self.zW)

  def loss_fn(self, batch, gen=None):
    flat = self.prep(batch)
    dec, vq_loss, perplexity = self.module(flat['lcd'], flat['proprio'])
    recon_lcd = -dec['lcd'].log_prob(flat['lcd']).mean()
    recon_proprio = -dec['proprio'].log_prob(flat['proprio']).mean() \
        / self.proprio_n
    loss = recon_lcd + recon_proprio + vq_loss
    return loss, {'loss/total': loss, 'loss/vq': vq_loss,
                  'loss/recon_lcd': recon_lcd,
                  'loss/recon_proprio': recon_proprio,
                  'perplexity': perplexity}

  def gathered_metrics(self, batch):
    """The codebook's perplexity is not a mean over shards: under --mesh
    it is taken over the whole batch's codes."""
    flat = self.prep(batch)
    z = self.module.encoder(flat['lcd'], flat['proprio'])
    return {'perplexity': self.module.vq(z)[2]}

  def encode(self, batch, noise=False, gen=None, flatten=True):
    z = self.module.enc(batch['lcd'], batch['proprio'])
    if flatten:
      z = z.reshape(z.shape[0], -1)
    return z

  def unflatten_z(self, z):
    return z.reshape(-1, self.zH, self.zW, self.G.vqD)

  def decode(self, z):
    if z.dim() == 2:
      z = self.unflatten_z(z)
    return self.module.dec(z)

  def sample_z(self, gen, n):
    return torch.randn((n, self.zH, self.zW, self.G.vqD), generator=gen,
                       device=self.device)
