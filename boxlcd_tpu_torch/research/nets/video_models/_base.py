"""VideoModel base: sampling + evaluation (the port of
research/nets/video_models/_base.py).

The prompted evaluation (SSIM/PSNR, proprio log-MSE) with green/red
prompt-boundary annotated videos, and the proprio re-render through the
env's batched teleport + raster on the device (the lcd raster kernel on the
card). Arbiter-based metrics (FVD, precision/recall, action log-MSE,
feature cosdist) wait for the arbiters' port and raise when an arbiter is
passed.
"""
from __future__ import annotations

import numpy as np
import torch

from boxlcd_tpu_torch.research import metrics as M
from boxlcd_tpu_torch.research import utils
from boxlcd_tpu_torch.research.nets._base import Net, to_device
from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    no_arbiter, re_render_proprio)

GREEN = np.array([0.0, 1.0, 0.0])
RED = np.array([1.0, 0.0, 0.0])


def chop(x, window):
  """Non-overlapping window chop along time (reference: evaler.py:56-62)."""
  rem = x.shape[1] % window
  if rem:
    x = x[:, :-rem]
  return x.reshape(-1, window, *x.shape[2:])


class VideoModel(Net):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.act_n = env.act_size
    self.proprio_n = max(1, env.pobs_size)
    self.block_size = G.window

  # subclass contract: sample(gen, n, action=None, prompts=None, prompt_n=10,
  #                           temp=1.0) -> {'lcd': (n,T,H,W), 'proprio': ...}
  # and onestep(batch, i, gen, temp) for learned-env serving.

  def _re_render_proprio(self, proprio):
    """(B, T, pobs) predicted proprio -> (B, T, H, W) frames."""
    B, T = proprio.shape[:2]
    lcd = re_render_proprio(self.env, proprio)
    return lcd.reshape(B, T, *lcd.shape[1:])

  def _annot_video(self, pred, truth=None, prompt_n=None):
    """(B,T,3,H,W') float video: truth | pred | error side by side, with the
    prompt boundary marked green/red (reference: _base.py:159-188)."""
    pred = np.asarray(pred, np.float32)
    if truth is not None:
      truth = np.asarray(truth, np.float32)
      err = (pred - truth + 1.0) / 2.0
      bar = np.zeros_like(pred[..., :1])
      out = np.concatenate([truth, bar, pred, bar, err], axis=-1)
    else:
      out = pred
    out = out[:, :, None].repeat(3, 2)  # (B, T, 3, H, W')
    if prompt_n is not None:
      out[:, :prompt_n, :, :, 0] = GREEN[None, None, :, None]
      out[:, prompt_n:, :, :, 0] = RED[None, None, :, None]
      out[:, :prompt_n, :, 0, :] = GREEN[None, None, :, None]
      out[:, prompt_n:, :, 0, :] = RED[None, None, :, None]
    return out

  @torch.no_grad()
  def evaluate(self, writer, batch, itr, arbiter=None):
    no_arbiter(arbiter)
    metrics = {}
    batch = to_device(batch, self.device)
    n = min(self.G.video_n, batch['lcd'].shape[0])
    prompt_n = self.G.prompt_n
    T = self.block_size
    # --- unprompted, random actions (reference: _base.py:40-82)
    rand_act = torch.rand((n, T, self.act_n), generator=self.gen,
                          device=self.device) * 2 - 1
    sample = self.sample(self.gen, n, action=rand_act)
    # --- prompted (reference: _base.py:97-157)
    prompts = {k: v[:n] for k, v in batch.items() if k != 'action'}
    action = batch['action'][:n, :T]
    psample = self.sample(self.gen, n, action=action, prompts=prompts,
                          prompt_n=prompt_n)
    lcd_t = batch['lcd'][:n, :T]
    lcd_p = psample['lcd'].reshape(lcd_t.shape)
    metrics['eval/prompted_lcd_ssim'] = float(
        M.ssim(lcd_p[:, prompt_n:], lcd_t[:, prompt_n:]))
    metrics['eval/prompted_lcd_psnr'] = float(
        M.psnr(lcd_p[:, prompt_n:], lcd_t[:, prompt_n:]))
    pt = batch['proprio'][:n, :T]
    pp = psample['proprio']
    if self.env.pobs_size:  # passive envs have no proprio
      metrics['eval/prompted_proprio_log_mse'] = float(
          torch.log(((pt[:, prompt_n:] - pp[:, prompt_n:]) ** 2).mean()))
    if writer is not None:
      utils.add_video(writer, 'eval/unprompted_lcd',
                      self._annot_video(sample['lcd'].cpu().numpy()), itr,
                      fps=self.G.fps)
      utils.add_video(writer, 'eval/prompted_lcd',
                      self._annot_video(lcd_p.cpu().numpy(),
                                        lcd_t.cpu().numpy(),
                                        prompt_n=prompt_n), itr,
                      fps=self.G.fps)
      # re-render predicted proprio through the env (reference: _base.py:190-228)
      pl = self._re_render_proprio(pp).float().cpu().numpy()
      tl = self._re_render_proprio(pt).float().cpu().numpy()
      utils.add_video(writer, 'eval/prompted_proprio',
                      self._annot_video(pl, tl, prompt_n=prompt_n), itr,
                      fps=self.G.fps)
    return metrics
