"""Autoencoder base: encode/decode contract + shared evaluation.

The port of research/nets/autoencoders/_base.py: the same encode /
decode_mode / decode / sample surface, with evaluation that re-renders
proprio predictions through the env's batched teleport + raster on the
device (`Env.teleport` + `Env.observe`: the lcd raster kernel on the card),
and, handed a frozen ArbiterAE (`runners/trainer.load_arbiter`), the FID of
samples and the feature cosdist of reconstructions.
"""
from __future__ import annotations

import numpy as np
import torch

from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research import metrics as M
from boxlcd_tpu_torch.research.nets._base import Net, to_device


def flat01(x):
  """(B, T, ...) -> (B*T, ...)."""
  return x.reshape(-1, *x.shape[2:])


def re_render_proprio(env, proprio):
  """(N, pobs) proprio -> (N, H, W) frames of the env teleported there."""
  gen = torch.Generator(device=env.device)
  gen.manual_seed(0)
  proprio = proprio.reshape(-1, proprio.shape[-1])[:, :env.pobs_size]
  st = Env.teleport(env, gen, proprio=proprio.to(env.device))
  return Env.observe(env, st)['lcd']


def cosdist(a, b):
  """Mean cosine distance of paired feature rows."""
  cos = (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                           * torch.linalg.norm(b, dim=-1) + 1e-8)
  return (1 - cos).mean()


def lcd_hw(G):
  """The frame size a model is built for, as the JAX init_params take it."""
  return G.lcd_base, int(G.lcd_base * G.wh_ratio)


class Autoencoder(Net):
  """Subclasses define: build, loss_fn, encode(batch, noise), decode(z) ->
  {'lcd': dist, 'proprio': dist}, sample_z(gen, n)."""

  def __init__(self, env, G):
    super().__init__(env, G)
    self.proprio_n = max(1, env.pobs_size)

  def decode_mode(self, z):
    dec = self.decode(z)
    return {'lcd': dec['lcd'].mode, 'proprio': dec['proprio'].mean}

  def sample(self, gen, n):
    return self.decode_mode(self.sample_z(gen, n))

  @torch.no_grad()
  def evaluate(self, writer, batch, itr, arbiter=None):
    """Prompted recon metrics; with an ArbiterAE (a MultiStepArbiter is
    ignored) the FID of prior samples against the batch and the feature
    cosdist of the reconstructions; with a writer, the truth/recon/error
    grids and the proprio re-render (reference _base.py:44-132)."""
    metrics = {}
    batch = to_device(batch, self.device)
    flat = self.prep({k: v for k, v in batch.items() if k != 'action'})
    z = self.encode(flat, noise=False)
    recon = self.decode_mode(z)
    lcd_t = flat['lcd'][:, None] if flat['lcd'].dim() == 3 else flat['lcd']
    lcd_p = recon['lcd'].reshape(lcd_t.shape)
    metrics['eval/lcd_ssim'] = M.ssim(lcd_p, lcd_t)
    metrics['eval/lcd_psnr'] = M.psnr(lcd_p, lcd_t)
    pt, pp = flat['proprio'], recon['proprio']
    metrics['eval/proprio_log_mse'] = torch.log(((pt - pp) ** 2).mean())
    cos = (pt * pp).sum(-1) / (
        torch.linalg.norm(pt, dim=-1) * torch.linalg.norm(pp, dim=-1) + 1e-8)
    metrics['eval/proprio_cosdist'] = 1 - cos.mean()
    sample = self.sample(self.gen, flat['lcd'].shape[0])
    if arbiter is not None and arbiter['kind'] == 'ArbiterAE':
      sq = lambda x: x[:, 0] if (x.dim() == 4 and x.shape[1] == 1) else x
      feats = lambda lcd, proprio: arbiter['fn'](
          {'lcd': sq(lcd), 'proprio': proprio})[0]
      saz = feats(sample['lcd'], sample['proprio'])
      taz = feats(lcd_t, pt)
      metrics['eval/fid'] = M.fid(saz, taz)
      metrics['eval/cosdist'] = cosdist(feats(lcd_p, pp), taz)
    if writer is not None:
      k = min(8, lcd_t.shape[0])
      img_t = lcd_t[:k, 0].cpu().numpy()
      img_p = lcd_p[:k, 0].cpu().numpy()
      err = (img_p - img_t + 1.0) / 2.0
      grid = np.concatenate([img_t, img_p, err], axis=1)  # truth/recon/error
      writer.add_image('eval/recon_lcd',
                       grid.transpose(1, 0, 2).reshape(1, grid.shape[1], -1),
                       itr)
      # proprio re-render plots (reference: _base.py:63-82)
      rr_p = re_render_proprio(self.env, pp[:k]).float().cpu().numpy()
      rr_t = re_render_proprio(self.env, pt[:k]).float().cpu().numpy()
      rerr = (rr_p - rr_t + 1.0) / 2.0
      rgrid = np.concatenate([rr_t, rr_p, rerr], axis=1)
      writer.add_image('eval/recon_proprio',
                       rgrid.transpose(1, 0, 2).reshape(1, rgrid.shape[1], -1),
                       itr)
      simg = sample['lcd'][:k].cpu().numpy()
      simg = simg[:, 0] if simg.ndim == 4 else simg
      writer.add_image('eval/sample_lcd',
                       simg.transpose(1, 0, 2).reshape(1, simg.shape[1], -1),
                       itr)
    return {k: float(v) for k, v in metrics.items()}


class SingleStepAE(Autoencoder):
  """Flattens the time axis into batch before the loss (reference: :134-146)."""

  def prep(self, batch):
    return {k: flat01(v) for k, v in batch.items() if k != 'action'}


class MultiStepAE(Autoencoder):
  """Keeps (B, window, ...) batches (reference: :141-195)."""

  def prep(self, batch):
    return batch
