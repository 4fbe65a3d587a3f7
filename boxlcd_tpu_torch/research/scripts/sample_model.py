"""Prompted-sample figure: truth row / sample row / error row as one PNG
(the port of research/scripts/sample_model.py; reference:
research/scripts/evaluations/sample_model.py:39-70): roll a real episode
under seeded random actions, prompt the model with the first frame, sample
the rest, and save a side-by-side frame strip with the prompt boundary
marked.

    python -m boxlcd_tpu_torch.research.scripts.sample_model --env=Urchin \
        --model=FBT --weightdir=<trained model dir> \
        [--outdir=logs/figs --frames=20 --fig_prompt_n=1 --fig_seed=7 \
         --device=cpu]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research.main import load_model, parse_flags
from boxlcd_tpu_torch.research.nets._base import Net
from boxlcd_tpu_torch.research.runners.vizer import truth_rollout


def real_rollout(env, gen, T):
  """(1, T) batch of {lcd, proprio, action} tensors from the real sim: a
  reset and T uniform random actions drawn from `gen`; each frame is the
  observation after its action."""
  state = Env.reset(env, gen, 1)
  actions = torch.rand((T, env.act_size), generator=gen,
                       device=env.device) * 2 - 1
  truth = truth_rollout(env, state, actions)
  return {'lcd': truth['lcd'][None].float(),
          'proprio': truth['proprio'][None], 'action': actions[None]}


def frame_strip(truth, pred, prompt_n, frames):
  """(T,H,W) x2 -> one RGB strip image: truth / sample / error stacked, one
  column per frame, red separator at the prompt boundary (reference
  sample_model.py:55-69)."""
  cols = []
  for i in range(min(frames, truth.shape[0])):
    t, x = truth[i], pred[i]
    err = (t - x + 1.0) / 2.0
    blank = np.zeros_like(x)[:1]
    col = np.concatenate([t, blank, x, blank, err], 0)[..., None].repeat(3, -1)
    cols.append(col)
    sep = np.zeros_like(col)[:, :1]
    if i == prompt_n - 1:
      sep[..., 0] = 1.0  # red: everything right of this is sampled
    cols.append(sep)
  img = np.concatenate(cols[:-1], 1).repeat(8, 0).repeat(8, 1)
  return np.clip(img, 0, 1)


def main(argv=None):
  argv = list(sys.argv[1:] if argv is None else argv)
  outdir, frames, prompt_n, seed = Path('logs/figs'), 20, 1, 7
  keep = []
  for a in argv:
    if a.startswith('--outdir='):
      outdir = Path(a.split('=', 1)[1])
    elif a.startswith('--frames='):
      frames = int(a.split('=', 1)[1])
    elif a.startswith('--fig_prompt_n='):
      prompt_n = int(a.split('=', 1)[1])
    elif a.startswith('--fig_seed='):
      seed = int(a.split('=', 1)[1])
    else:
      keep.append(a)
  G, env = parse_flags(keep)

  # roll the real episode first, as the JAX script does
  T = int(Net.load_config(G.weightdir, G.model).window)
  dev = env.device
  batch = real_rollout(env, torch.Generator(device=dev).manual_seed(seed), T)

  model = load_model(G, env)
  print(f'LOADED {G.model} from {G.weightdir}')
  prompts = {k: v for k, v in batch.items() if k != 'action'}
  sample = model.sample(torch.Generator(device=dev).manual_seed(seed + 1), 1,
                        action=batch['action'], prompts=prompts,
                        prompt_n=prompt_n)
  truth = batch['lcd'][0].cpu().numpy()
  pred = sample['lcd'].float().cpu().numpy().reshape(truth.shape)
  img = frame_strip(truth, pred, prompt_n, frames)

  outdir.mkdir(parents=True, exist_ok=True)
  path = outdir / f'{G.env}_frames.png'
  from PIL import Image
  Image.fromarray((255 * img).astype(np.uint8)).save(path)
  print('wrote', path)
  return path, truth, pred


if __name__ == '__main__':
  main()
