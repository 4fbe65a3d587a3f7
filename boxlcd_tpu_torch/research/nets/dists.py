"""Minimal distribution toolkit in torch (the port of research/nets/dists.py).

Small stateless classes with the same stable log-prob forms as the JAX
package. Sampling takes an explicit `torch.Generator` (or a shard's, from
`parallel.ShardDraws`, under `--mesh`); where a test must
feed both packages the same noise, `sample` also takes the uniforms (or
normals) themselves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from boxlcd_tpu_torch import parallel


def _uniform(shape, gen, device):
  return parallel.rand(shape, gen, device)


class Bernoulli:
  """Independent Bernoulli over the trailing dims, parameterized by logits."""

  def __init__(self, logits):
    self.logits = logits

  @property
  def probs(self):
    return torch.sigmoid(self.logits)

  def log_prob(self, x):
    # -softplus(-l)*x - softplus(l)*(1-x), numerically stable. At l == 0
    # (a zero-initialised head over dead ReLUs gives it exactly) the
    # subgradients are the JAX form's: max splits the tie, |l| has slope 1
    # (clamp and abs would give 1 and 0, a gradient off by 1 there)
    l = self.logits
    return -torch.maximum(l, torch.zeros_like(l)) + l * x \
        - torch.log1p(torch.exp(-torch.where(l >= 0, l, -l)))

  def sample(self, gen=None, temp=1.0, u=None):
    """Bits u < sigmoid(logits / temp); u uniform in [0, 1) from `gen`
    unless given."""
    if u is None:
      u = _uniform(self.logits.shape, gen, self.logits.device)
    return (u < torch.sigmoid(self.logits / temp)).float()

  def entropy(self):
    # logit-space form; stable where sigmoid saturates
    p = self.probs
    return p * F.softplus(-self.logits) + (1 - p) * F.softplus(self.logits)

  @property
  def mode(self):
    return (self.probs > 0.5).float()


class Normal:
  """Diagonal Gaussian; log_prob sums over the final axis if `independent`."""

  def __init__(self, mean, std, independent=True):
    self.mean = mean
    self.std = std
    self.independent = independent

  def log_prob(self, x):
    lp = -0.5 * (((x - self.mean) / self.std) ** 2
                 + 2 * torch.log(self.std) + math.log(2 * math.pi))
    return lp.sum(-1) if self.independent else lp

  def sample(self, gen=None, eps=None):
    if eps is None:
      eps = parallel.randn(self.mean.shape, gen, self.mean.device)
    return self.mean + self.std * eps

  def kl(self, other):
    return (torch.log(other.std / self.std)
            + (self.std ** 2 + (self.mean - other.mean) ** 2)
            / (2 * other.std ** 2) - 0.5)

  def entropy(self):
    return 0.5 * (1 + math.log(2 * math.pi)) + torch.log(self.std)


class Categorical:
  def __init__(self, logits):
    self.logits = logits

  @property
  def probs(self):
    return torch.softmax(self.logits, -1)

  def log_prob(self, x):
    """x: integer class indices."""
    logp = torch.log_softmax(self.logits, -1)
    return torch.take_along_dim(logp, x[..., None].long(), -1).squeeze(-1)

  def sample(self, gen=None, temp=1.0, u=None):
    """Gumbel-max over logits / temp, as jax.random.categorical draws."""
    if u is None:
      u = _uniform(self.logits.shape, gen, self.logits.device)
    tiny = torch.finfo(u.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(self.logits / temp + gumbel, -1)

  def entropy(self):
    logp = torch.log_softmax(self.logits, -1)
    return -(torch.exp(logp) * logp).sum(-1)


class MixtureOfGaussians:
  """MDN: mixture over k diagonal Gaussians (reference: common.py:93-112)."""

  def __init__(self, logits, means, stds):
    """logits (..., k); means/stds (..., k, d)."""
    self.logits = logits
    self.means = means
    self.stds = stds

  def log_prob(self, x):
    comp_lp = -0.5 * (((x[..., None, :] - self.means) / self.stds) ** 2
                      + 2 * torch.log(self.stds) + math.log(2 * math.pi))
    comp_lp = comp_lp.sum(-1)                            # (..., k)
    mix_lp = torch.log_softmax(self.logits, -1)
    return torch.logsumexp(comp_lp + mix_lp, -1)

  def sample(self, gen=None):
    idx = Categorical(self.logits).sample(gen)           # (...,)
    sel = idx[..., None, None].expand(*idx.shape, 1, self.means.shape[-1])
    mean = torch.take_along_dim(self.means, sel, -2).squeeze(-2)
    std = torch.take_along_dim(self.stds, sel, -2).squeeze(-2)
    return Normal(mean, std).sample(gen)

  @property
  def mean(self):
    w = torch.softmax(self.logits, -1)
    return (w[..., None] * self.means).sum(-2)
