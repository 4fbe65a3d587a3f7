"""Standalone generic causal GPT with per-token sampling (the port of
research/nets/gpt.py): shift-right input, learned pos-emb, binary or
categorical head, optional conditioning vector.

Submodules carry the flax names (`embed`, `cond_in`, `pos_emb`,
`block<i>`, `ln_f`, `head`), so `convert.load_flax` carries a flax GPT's
parameters over as they are.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.common import (
    Dense, LayerNorm, TransformerBlock)


class GPT(nn.Module):
  def __init__(self, in_size, block_size, n_embed=128, n_head=4, n_layer=2,
               dist='binary', cond=0, out_n=None):
    super().__init__()
    self.in_size, self.block_size = in_size, block_size
    self.n_layer, self.dist, self.cond = n_layer, dist, cond
    half = n_embed // 2 if cond else n_embed
    self.embed = Dense(in_size, half, bias=False)
    if cond:
      self.cond_in = Dense(cond, n_embed - half, bias=False)
    # nonzero init required: shift-right makes the t=0 token all-zero, and a
    # zero vector through LayerNorm has a 1/sqrt(eps) backward blowup that
    # compounds per block to inf grads (clip then zeroes every update)
    self.pos_emb = nn.Parameter(torch.randn(1, block_size, n_embed) * 0.02)
    for i in range(n_layer):
      setattr(self, f'block{i}',
              TransformerBlock(n_embed, n_head, block_size))
    self.ln_f = LayerNorm(n_embed)
    self.head = Dense(n_embed, out_n or in_size)

  def forward(self, x, cond=None):
    """x (B, T, in_size); cond (B, cond) or (B, T, cond) -> dist over
    tokens."""
    B, T, _ = x.shape
    h = self.embed(x)
    h = torch.cat([h.new_zeros((B, 1, h.shape[-1])), h[:, :-1]], 1)
    if self.cond:
      c = self.cond_in(cond)
      if c.dim() == 2:
        c = c[:, None].expand(B, T, c.shape[-1])
      h = torch.cat([h, c], -1)
    h = h + self.pos_emb[:, :T]
    for i in range(self.n_layer):
      h = getattr(self, f'block{i}')(h)
    logits = self.head(self.ln_f(h))
    if self.dist == 'binary':
      return dists.Bernoulli(logits)
    return dists.Categorical(logits)


@torch.no_grad()
def sample(module, gen, n, block_size, in_size, cond=None, temp=1.0, u=None):
  """Per-token AR sampling loop (JAX: gpt.py:53-67): position i's
  tokens are Bernoulli draws from its logits / temp, with uniforms u
  (block_size, n, in_size) drawn from `gen` unless given."""
  device = module.pos_emb.device
  if u is None:
    u = torch.rand((block_size, n, in_size), generator=gen, device=device)
  x = torch.zeros((n, block_size, in_size), device=device)
  for i in range(block_size):
    logits = module(x, cond).logits[:, i]
    x[:, i] = dists.Bernoulli(logits / temp).sample(u=u[i])
  return x


class GPTDist:
  """Distribution-style wrapper over a GPT: log_prob over scalar token
  streams and conditional sampling (JAX: gpt.py:70-96). Conditioning
  x has shape (B, T, c); token streams (B, T, L)."""

  def __init__(self, module, gen, x):
    self.module = module
    self.gen = gen
    self.x = x

  def _flat(self, a):
    return a.reshape(-1, *a.shape[2:])

  def log_prob(self, state):
    s = self._flat(state)[..., None]
    return self.module(s, self._flat(self.x)).log_prob(s)

  def sample(self, u=None):
    """Token streams (B, T, L); u (L, B * T, 1) as `sample` takes it."""
    B, T = self.x.shape[:2]
    out = sample(self.module, self.gen, B * T, self.module.block_size,
                 self.module.in_size, cond=self._flat(self.x), u=u)
    return out.reshape(B, T, -1)
