"""FIT (Flat Image Token): a GPT over whole flattened frames as tokens,
Bernoulli pixels (the port of research/nets/video_models/fit.py).

Its module is FBT's transformer with the frame's pixels for tokens: the
same layers under the same flax names (`embed`, `cond_in`, `pos_emb`,
`block<i>`, `ln_f`, `dist_head`), so `FBTModule` serves it as it is.
Sampling runs the full forward per position, as the JAX scan does.
"""
from __future__ import annotations

import torch

from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.video_models._base import VideoModel
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBTModule


class FIT(VideoModel):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.lcd_h = int(G.lcd_base)
    self.lcd_w = int(G.lcd_base * G.wh_ratio)
    self.imsize = self.lcd_h * self.lcd_w
    self._init()

  def build(self):
    G = self.G
    return FBTModule(G.n_embed, G.n_head, G.n_layer, self.block_size,
                     self.imsize, self.act_n)

  def loss_fn(self, batch, gen=None):
    B, T = batch['lcd'].shape[:2]
    lcd = batch['lcd'].reshape(B, T, -1)
    logits = self.module(lcd, batch['action']).float()
    loss = -dists.Bernoulli(logits).log_prob(lcd).mean()
    return loss, {'loss/lcd': loss, 'loss/total': loss}

  @torch.no_grad()
  def onestep(self, batch, i, gen, temp=1.0, u=None):
    """Learned-env serving: sample frame i from the window (JAX:
    fit.py:63-70); the pixel draws read uniforms u (B, imsize), drawn from
    `gen` unless given."""
    B, T = batch['lcd'].shape[:2]
    logits = self.module(batch['lcd'].reshape(B, T, -1), batch['action'])
    frame = dists.Bernoulli(logits[:, i] / temp).sample(gen, u=u)
    batch = dict(batch)
    batch['lcd'] = batch['lcd'].clone()
    batch['lcd'][:, i] = frame.reshape(B, self.lcd_h, self.lcd_w)
    return batch

  @torch.no_grad()
  def sample(self, gen, n, action=None, prompts=None, prompt_n=10, temp=1.0,
             u=None):
    """AR rollout over frames (JAX: fit.py:72-101): the prompt is
    written first, then positions prompt_n.. are drawn one at a time, each
    from a full forward, with uniforms u (T, n, imsize) drawn from `gen`
    after the actions unless given."""
    T = self.block_size
    if action is None:
      action = torch.rand((n, T, self.act_n), generator=gen,
                          device=self.device) * 2 - 1
    n = action.shape[0]
    if u is None:
      u = torch.rand((T, n, self.imsize), generator=gen, device=self.device)
    lcd = torch.zeros((n, T, self.imsize), device=self.device)
    start = 0
    if prompts is not None:
      lcd[:, :prompt_n] = prompts['lcd'][:, :prompt_n].reshape(
          n, prompt_n, -1).float()
      start = prompt_n
    for i in range(start, T):
      logits = self.module(lcd, action)[:, i]
      lcd[:, i] = dists.Bernoulli(logits / temp).sample(u=u[i])
    return {'lcd': lcd.reshape(n, T, self.lcd_h, self.lcd_w),
            'proprio': torch.zeros((n, T, self.proprio_n),
                                   device=self.device)}
