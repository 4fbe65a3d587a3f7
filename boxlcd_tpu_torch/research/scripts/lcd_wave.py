"""LCD-wave demo gif: a rolling episode whose frame sweeps from the pretty
high-res RGB render to the tiny LCD render, column by column (the port of
research/scripts/lcd_wave.py; reference: research/scripts/evaluations/
lcd_wave.py:47-81, the repo's marquee gif).

Frames come from the batched renderers (render/raster.py rgb_render and
lcd_render, the latter one launch of the LCD raster kernel over all T
frames) on a functional rollout; no pyglet window is needed.

    python -m boxlcd_tpu_torch.research.scripts.lcd_wave \
        [--env=UrchinBall --steps=120 --outdir=logs/figs --device=cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import raster
from boxlcd_tpu_torch.utils import resolve_device


def rollout_poses(env, gen, steps):
  """is_circle (n,), positions (T, n, 2) and angles (T, n) of one episode
  under uniform random actions, the pose after each step."""
  state = Env.reset(env, gen, 1)
  actions = torch.rand((steps, env.act_size), generator=gen,
                       device=env.device) * 2 - 1
  c, a = [], []
  for act in actions:
    state, *_ = Env.step(env, state, act[None])
    c.append(state.c[0])
    a.append(state.a[0])
  return state.is_circle[0], torch.stack(c), torch.stack(a)


def wave_frames(env, is_circle, c, a):
  """(T, H*, W* + 2, 3) float frames in [0, 1]: the LCD render takes over
  from the RGB render from the left as the episode progresses
  (reference lcd_wave.py:60-64)."""
  W, H = env.lcd_w, env.lcd_h
  up = 256 // W  # pretty render upscale so both renders share pixel dims
  T = c.shape[0]
  ic = is_circle[None].repeat(T, 1)   # the raster kernel takes contiguous poses
  pretty = raster.rgb_render(env.spec, ic, c, a, W * up, H * up)
  lcd = raster.lcd_render(env.spec, ic, c, a, W, H)
  pretty = pretty.cpu().numpy().astype(np.float32) / 255.0  # (T, H*, W*, 3)
  lcd = lcd.cpu().numpy().astype(np.float32)[..., None].repeat(3, -1)
  lcd = lcd.repeat(up, 1).repeat(up, 2)                      # match pretty
  frames = []
  full = W * up
  for i in range(T):
    idx = int(np.clip(0.9 * up * (i - 10), 0, full))
    if idx >= full:
      frame = np.concatenate([lcd[i], np.zeros_like(lcd[i])[:, :2]], 1)
    else:
      frame = np.concatenate(
          [lcd[i][:, :idx], np.zeros_like(lcd[i])[:, :2],
           pretty[i][:, -(full - idx):]], 1)
    frames.append(frame)
  return frames


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--env', default='UrchinBall')
  parser.add_argument('--steps', type=int, default=120)
  parser.add_argument('--outdir', default='logs/figs')
  parser.add_argument('--seed', type=int, default=7)
  parser.add_argument('--fps', type=int, default=30)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  device = resolve_device(args.device)
  env = boxlcd_tpu_torch.env_map[args.env](device=device)
  gen = torch.Generator(device=device).manual_seed(args.seed)
  frames = wave_frames(env, *rollout_poses(env, gen, args.steps))

  out = Path(args.outdir)
  out.mkdir(parents=True, exist_ok=True)
  # write_gif expects grayscale (T,H,W); RGB path via PIL directly
  from PIL import Image
  imgs = [Image.fromarray((255 * f).astype(np.uint8)) for f in frames]
  path = out / f'{args.env}_wave.gif'
  imgs[0].save(path, save_all=True, append_images=imgs[1:],
               duration=int(1000 / args.fps), loop=0)
  print('wrote', path)
  return path


if __name__ == '__main__':
  main()
