"""Demo gifs of each env under random actions (the port of
research/scripts/demo_gifs.py; reference: research/scripts/evaluations/
{demo_imgs,lcd_wave,viz}.py, the repo's media makers).

    python -m boxlcd_tpu_torch.research.scripts.demo_gifs \
        [--envs=Dropbox,Bounce,Urchin,Luxo --steps=50 --outdir=logs/demos \
         --device=cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research.runners.vizer import truth_rollout
from boxlcd_tpu_torch.research.utils import write_gif
from boxlcd_tpu_torch.utils import resolve_device


def rollout_frames(env, gen, steps):
  """(steps, H, W) float32 frames of one episode from a reset, under
  uniform random actions, all drawn from `gen`."""
  state = Env.reset(env, gen, 1)
  actions = torch.rand((steps, env.act_size), generator=gen,
                       device=env.device) * 2 - 1
  return truth_rollout(env, state, actions)['lcd'].float().cpu().numpy()


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--envs', default='Dropbox,Bounce,Urchin,Luxo')
  parser.add_argument('--outdir', default='logs/demos')
  parser.add_argument('--steps', type=int, default=50)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  device = resolve_device(args.device)
  out = Path(args.outdir)
  out.mkdir(parents=True, exist_ok=True)
  paths = {}
  for name in args.envs.split(','):
    env = boxlcd_tpu_torch.env_map[name](device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    frames = rollout_frames(env, gen, args.steps)
    paths[name] = write_gif(out / f'{name}.gif', frames)
    print('wrote', paths[name])
  return paths


if __name__ == '__main__':
  main()
