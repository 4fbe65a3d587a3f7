"""FRNLD: FBT's transformer over a frozen RNLDA's latents, with a tanh-MSE
regression head (the port of research/nets/video_models/frnld.py).

The frozen RNLDA is loaded from G.weightdir (the port's checkpoint,
`RNLDA.pkl`); its parameters never enter FRNLD's optimizer. Draws go
through `quantize.rnld(..., noise=True)`, whose uniforms can be handed in.
"""
from __future__ import annotations

import torch

from boxlcd_tpu_torch.research.nets.common import Dense
from boxlcd_tpu_torch.research.nets.quantize import rnld
from boxlcd_tpu_torch.research.nets.video_models._base import VideoModel
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBTModule


class FRNLDModule(FBTModule):
  """FBT's transformer with a linear head, `out_net` (flax's name), over
  the z_size latent values."""

  def make_head(self, n_embed, z_size):
    self.out_net = Dense(n_embed, z_size)

  def head(self, x):
    return self.out_net(x)


class FRNLD(VideoModel):
  def __init__(self, env, G, ronald=None):
    super().__init__(env, G)
    if ronald is None:
      from boxlcd_tpu_torch.research.nets._base import Net
      from boxlcd_tpu_torch.research.nets.autoencoders.rnlda import RNLDA
      ronald = RNLDA(env, Net.load_config(G.weightdir, 'RNLDA'))
      ronald.load(G.weightdir, resume=False)
      print('LOADED RNLDA', G.weightdir)
    self.ronald = ronald  # frozen: its params never enter the optimizer
    self.ronald.module.requires_grad_(False)
    self.z_size = ronald.z_size
    self._init()

  def build(self):
    G = self.G
    return FRNLDModule(G.n_embed, G.n_head, G.n_layer, self.block_size,
                       self.z_size, self.act_n)

  def loss_fn(self, batch, gen=None):
    with torch.no_grad():
      z = self.ronald.encode(batch, noise=False)
    out = self.module(z, batch['action']).float()
    loss = ((torch.tanh(out) - z) ** 2).mean()
    return loss, {'loss/total': loss}

  def _decode(self, z):
    """Latents (N, z_size) -> (frames (N, H, W) as 0/1, proprio means)."""
    dec = self.ronald.decode(self.ronald.unflatten_z(z))
    return (dec['lcd'].probs > 0.5).float(), dec['proprio'].mean

  @torch.no_grad()
  def onestep(self, batch, i, gen, temp=1.0, u=None):
    """Learned-env serving: predict frame i from the window (JAX:
    frnld.py:69-77); the rnld noise reads uniforms u (B, z_size), drawn
    from `gen` unless given."""
    z = self.ronald.encode(batch, noise=False)
    out = self.module(z, batch['action'])
    zi, _ = rnld(out[:, i], gen, noise=True, u=u)
    lcd, proprio = self._decode(zi)
    batch = dict(batch)
    batch['lcd'] = batch['lcd'].clone()
    batch['proprio'] = batch['proprio'].clone()
    batch['lcd'][:, i] = lcd
    batch['proprio'][:, i] = proprio
    return batch

  @torch.no_grad()
  def sample(self, gen, n, action=None, prompts=None, prompt_n=10, temp=1.0,
             u=None):
    """AR rollout in latent space, then one batch decode (JAX:
    frnld.py:79-115): the prompt's latents are written first, then
    positions prompt_n.. are drawn one at a time from a full forward, with
    rnld uniforms u (T, n, z_size) drawn from `gen` after the actions
    unless given."""
    T = self.block_size
    if action is None:
      action = torch.rand((n, T, self.act_n), generator=gen,
                          device=self.device) * 2 - 1
    n = action.shape[0]
    if u is None:
      u = torch.rand((T, n, self.z_size), generator=gen, device=self.device)
    lcd = torch.zeros((n, T, self.env.lcd_h, self.env.lcd_w),
                      device=self.device)
    proprio = torch.zeros((n, T, self.proprio_n), device=self.device)
    start = 0
    if prompts is not None:
      lcd[:, :prompt_n] = prompts['lcd'][:, :prompt_n]
      proprio[:, :prompt_n] = prompts['proprio'][:, :prompt_n]
      start = prompt_n
    z = self.ronald.encode({'lcd': lcd, 'proprio': proprio}, noise=False)
    z[:, start:] = 0.0
    for i in range(start, T):
      out = self.module(z, action)[:, i]
      z[:, i], _ = rnld(out, noise=True, u=u[i])
    lcd, proprio = self._decode(z.reshape(n * T, -1))
    return {'lcd': lcd.reshape(n, T, *lcd.shape[1:]),
            'proprio': proprio.reshape(n, T, -1)}
