"""Latent quantizers (the port of research/nets/quantize.py).

Straight-through estimators written as `sample.detach() + x - x.detach()`;
the noise comes from an explicit `torch.Generator`, or is handed in (`u`)
where a test feeds both packages the same uniforms.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch import parallel


def binary_quantize(z_logits, gen=None, noise=True, u=None):
  """Bernoulli sample with straight-through probs (reference: quantize.py:55-68).

  Returns (z_q, entropy_mean, probs). noise=False gives the deterministic
  probs>0.5 mode used at encode/serve time; with noise, u (uniform in
  [0, 1), z_logits' shape) is drawn from `gen` unless given.
  """
  probs = torch.sigmoid(z_logits)
  # logit-space entropy: H = p*softplus(-l) + (1-p)*softplus(l); the naive
  # p*log(p) form NaNs once sigmoid saturates
  entropy = (probs * F.softplus(-z_logits)
             + (1 - probs) * F.softplus(z_logits)).mean()
  if noise:
    if u is None:
      u = parallel.rand(z_logits.shape, gen, z_logits.device)
    sample = (u < probs).float()
  else:
    sample = (probs > 0.5).float()
  z_q = sample.detach() + probs - probs.detach()  # straight-through
  return z_q, entropy, probs


def rnld(z, gen=None, noise=True, noise_level=0.25, u=None):
  """Real-Number-Line Discretization: 4 bins over tanh(z) with straight-through
  (reference: quantize.py:17-53). Returns (z_q, idxs)."""
  z = torch.tanh(z)
  if noise:
    if u is None:
      u = parallel.rand(z.shape, gen, z.device)
    zn = z + noise_level * (2 * u - 1)
  else:
    zn = z
  idxs = torch.bucketize(zn.contiguous(), zn.new_tensor([-0.5, 0.0, 0.5]),
                         right=True)
  z_q = zn.new_tensor([-0.75, -0.25, 0.25, 0.75])[idxs]
  z_q = z_q.detach() + z - z.detach()
  return z_q, idxs


class VectorQuantizer(nn.Module):
  """Classic VQ-VAE codebook (reference: quantize.py:70-106)."""

  def __init__(self, K, D, beta):
    super().__init__()
    self.K, self.D, self.beta = K, D, beta
    # flax's uniform(scale=2/K): U[0, 2/K)
    self.embedding = nn.Parameter(torch.rand(K, D) * (2.0 / K))

  def forward(self, z):
    emb = self.embedding
    flat = z.reshape(-1, self.D)
    d = ((flat ** 2).sum(-1, keepdim=True) + (emb ** 2).sum(-1)
         - 2 * flat @ emb.T)
    idx = torch.argmin(d, -1)
    z_q = emb[idx].reshape(z.shape)
    loss = ((z_q.detach() - z) ** 2).mean() \
        + self.beta * ((z_q - z.detach()) ** 2).mean()
    z_q = z + (z_q - z).detach()
    e_mean = F.one_hot(idx, self.K).float().mean(0)
    perplexity = torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())
    return loss, z_q, perplexity, idx.reshape(z.shape[:-1])
