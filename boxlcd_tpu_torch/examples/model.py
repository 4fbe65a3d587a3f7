"""Self-contained minimal video-GPT with Bernoulli pixels and bits/dim loss
(the port of examples/model.py; reference: examples/model.py, a
minGPT-style model).

The submodules carry the flax module's auto names (`Dense_0` the frame
embedding, `Dense_1` the action embedding, `pos_emb`,
`TransformerBlock_<i>`, `LayerNorm_0`, `Dense_2` the head), so
`research/nets/convert.load_flax` carries the flax parameters across.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.common import (
    Dense, LayerNorm, TransformerBlock)


class MiniGPT(nn.Module):
  def __init__(self, n_embed, n_head, n_layer, block_size, imsize, act_n):
    super().__init__()
    self.n_layer = n_layer
    self.Dense_0 = Dense(imsize, n_embed // 2, bias=False)
    self.Dense_1 = Dense(act_n, n_embed // 2, bias=False)
    self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embed))
    for i in range(n_layer):
      setattr(self, f'TransformerBlock_{i}',
              TransformerBlock(n_embed, n_head, block_size))
    self.LayerNorm_0 = LayerNorm(n_embed)
    self.Dense_2 = Dense(n_embed, imsize)

  def forward(self, lcd_flat, action):
    """lcd_flat (B, T, imsize), action (B, T, act_n) -> pixel logits
    (B, T, imsize); position t sees frames and actions before t."""
    B, T, _ = lcd_flat.shape
    x = self.Dense_0(lcd_flat)
    x = torch.cat([x.new_zeros((B, 1, x.shape[-1])), x[:, :-1]], 1)
    a = torch.cat([action.new_zeros((B, 1, action.shape[-1])),
                   action[:, :-1]], 1)
    x = torch.cat([x, self.Dense_1(a)], -1)
    x = x + self.pos_emb[:, :T]
    for i in range(self.n_layer):
      x = getattr(self, f'TransformerBlock_{i}')(x)
    return self.Dense_2(self.LayerNorm_0(x))


class Model:
  """MiniGPT with optax-equivalent Adam (b1 0.9, b2 0.999, eps 1e-8, no
  clipping), on `device` (the card unless given)."""

  def __init__(self, env, G, device=None):
    self.G = G
    self.device = torch.device(device) if device is not None else env.device
    self.imsize = env.lcd_h * env.lcd_w
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(0)
      self.module = MiniGPT(G.n_embed, G.n_head, G.n_layer, G.window,
                            self.imsize, env.act_size)
    self.module.to(self.device)
    self.opt = torch.optim.Adam(self.module.parameters(), lr=float(G.lr),
                                betas=(0.9, 0.999), eps=1e-8)

  def loss_fn(self, batch):
    """(nll, bits_per_dim) of the batch's frames under the model."""
    B, T = batch['lcd'].shape[:2]
    lcd = batch['lcd'].reshape(B, T, -1)
    logits = self.module(lcd, batch['action'])
    nll = -dists.Bernoulli(logits).log_prob(lcd).mean()
    return nll, nll / math.log(2.0)  # (reference: examples/model.py:121)

  def train_step(self, batch):
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
             for k, v in batch.items()}
    self.opt.zero_grad(set_to_none=False)
    loss, bpd = self.loss_fn(batch)
    loss.backward()
    self.opt.step()
    return {'loss': float(loss.detach()),
            'bits_per_dim': float(bpd.detach())}

  @torch.no_grad()
  def sample(self, gen, n, action, u=None):
    """(n, T, imsize) frames drawn position by position, each from a full
    forward over the frames so far; the pixel draws read uniforms u
    (T, n, imsize), drawn from `gen` unless given."""
    T = self.G.window
    action = torch.as_tensor(action, dtype=torch.float32, device=self.device)
    if u is None:
      u = torch.rand((T, n, self.imsize), generator=gen, device=self.device)
    lcd = torch.zeros((n, T, self.imsize), device=self.device)
    for i in range(T):
      logits = self.module(lcd, action)[:, i]
      lcd[:, i] = dists.Bernoulli(logits).sample(u=u[i])
    return lcd
