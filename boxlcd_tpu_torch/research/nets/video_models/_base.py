"""VideoModel base: sampling + evaluation (the port of
research/nets/video_models/_base.py).

The unprompted / prompted evaluation protocol: with a frozen
MultiStepArbiter (`runners/trainer.load_arbiter`), the FVD, precision /
recall / F1 and action log-MSE of samples drawn with random actions, and
the action log-MSEs and feature cosdist of prompted samples; SSIM/PSNR and
proprio log-MSE of the prompted ones; green/red prompt-boundary annotated
videos; and the proprio re-render through the env's batched teleport +
raster on the device (the lcd raster kernel on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from boxlcd_tpu_torch.research import metrics as M
from boxlcd_tpu_torch.research import utils
from boxlcd_tpu_torch.research.nets._base import Net, to_device
from boxlcd_tpu_torch.research.nets.autoencoders._base import (
    cosdist, re_render_proprio)

GREEN = np.array([0.0, 1.0, 0.0])
RED = np.array([1.0, 0.0, 0.0])


def chop(x, window):
  """Non-overlapping window chop along time (reference: evaler.py:56-62).
  A clip shorter than the window gives no window: (0, window, ...)."""
  rem = x.shape[1] % window
  if rem:
    x = x[:, :-rem]
  return x.reshape(-1, window, *x.shape[2:])


def uniform_actions(gen, shape, device):
  """Random actions, uniform in [-1, 1): the unprompted samples' actions."""
  return torch.rand(shape, generator=gen, device=device) * 2 - 1


def arbiter_feats(arbiter, batch, actions=None):
  """(features, action log-MSE or None) of a (B, T, ...) clip batch through
  a frozen arbiter, chopped to its window (reference: evaler.py:149-198):
  the arbiter's action predictions are scored against the actions used,
  one a transition (acts[:, :-1] of each window)."""
  aw = arbiter['window'] or batch['lcd'].shape[1]
  clip = {'lcd': chop(batch['lcd'], aw), 'proprio': chop(batch['proprio'], aw)}
  z, act_pred = arbiter['fn'](clip)
  almse = None
  if actions is not None and act_pred is not None:
    act = chop(actions, aw)[:, :-1]
    almse = torch.log(((act - act_pred) ** 2).mean())
  return z, almse


class VideoModel(Net):
  def __init__(self, env, G):
    super().__init__(env, G)
    self.act_n = env.act_size
    self.proprio_n = max(1, env.pobs_size)
    self.block_size = G.window

  # subclass contract: sample(gen, n, action=None, prompts=None, prompt_n=10,
  #                           temp=1.0) -> {'lcd': (n,T,H,W), 'proprio': ...}
  # and onestep(batch, i, gen, temp) for learned-env serving; optionally
  # encode_window(batch) -> the window's codes, which PPO.lenv_rollout then
  # carries in the window batch under 'z' for onestep to update (FBT).

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
    metrics = {}
    batch = to_device(batch, self.device)
    n = min(self.G.video_n, batch['lcd'].shape[0])
    prompt_n = self.G.prompt_n
    T = self.block_size
    # --- unprompted, random actions (reference: _base.py:40-82)
    rand_act = uniform_actions(self.gen, (n, T, self.act_n), self.device)
    sample = self.sample(self.gen, n, action=rand_act)
    if arbiter is not None:
      burned = {k: v[:, prompt_n:] for k, v in sample.items()
                if k in ('lcd', 'proprio')}
      paz, almse = arbiter_feats(arbiter, burned, rand_act[:, prompt_n:])
      tb = {k: v[:n, :T][:, prompt_n:] for k, v in batch.items()}
      taz, _ = arbiter_feats(arbiter, tb)
      metrics['eval/unprompted_fvd'] = float(M.fid(paz, taz))
      if almse is not None:
        metrics['eval/unprompted_action_log_mse'] = float(almse)
      pr = M.precision_recall_f1(taz, paz)
      for k, v in pr.items():
        metrics[f'eval/unprompted_{k}'] = float(v)
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
    if arbiter is not None:
      burned_act = action[:, prompt_n:]
      paz, almse = arbiter_feats(arbiter, {'lcd': lcd_p[:, prompt_n:],
                                           'proprio': pp[:, prompt_n:]},
                                 burned_act)
      taz, talmse = arbiter_feats(arbiter, {'lcd': lcd_t[:, prompt_n:],
                                            'proprio': pt[:, prompt_n:]},
                                  burned_act)
      if almse is not None:
        metrics['eval/prompted_action_log_mse'] = float(almse)
        metrics['eval/prompted_true_action_log_mse'] = float(talmse)
      metrics['eval/prompted_cosdist'] = float(cosdist(paz, taz))
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
