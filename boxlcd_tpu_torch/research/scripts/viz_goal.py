"""Goal-overlay figure: the current LCD frame overlaid with its goal frame
in red, tiled into a rows x cols grid PNG (the port of
research/scripts/viz_goal.py; reference: research/scripts/evaluations/
viz_goal.py:41-58): reset the goal env repeatedly and min-combine the lcd
with the red-tinted goal lcd.

    python -m boxlcd_tpu_torch.research.scripts.viz_goal --env=Urchin \
        [--rows=2 --cols=4 --outdir=logs/figs --device=cpu]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from boxlcd_tpu_torch.research.define_config import env_fn
from boxlcd_tpu_torch.research.main import parse_flags


def goal_overlay(obs):
  """(H,W) lcd + goal:lcd -> (H,W,3) with the goal silhouette in red."""
  lcd = 1.0 * obs['lcd'][..., None].repeat(3, -1)
  goal = 1.0 * obs['goal:lcd'][..., None].repeat(3, -1)
  goal[..., 0] = 1.0  # knock out G/B where the goal is drawn -> red
  return np.minimum(lcd, goal)


def goal_grid(env, rows, cols):
  """rows x cols goal overlays of fresh resets, 1-pixel black separators,
  upscaled 8x: an (H', W', 3) float image in [0, 1]."""
  all_rows = []
  for _ in range(rows):
    imgs = []
    for _ in range(cols):
      img = goal_overlay(env.reset())
      imgs += [img, np.zeros_like(img)[:, :1]]
    all_rows += [np.concatenate(imgs[:-1], 1)]
    all_rows += [np.zeros_like(all_rows[-1])[:1]]
  return np.clip(np.concatenate(all_rows[:-1]).repeat(8, 0).repeat(8, 1),
                 0, 1)


def main(argv=None):
  argv = list(sys.argv[1:] if argv is None else argv)
  outdir, rows, cols = Path('logs/figs'), 2, 4
  keep = []
  for a in argv:
    if a.startswith('--outdir='):
      outdir = Path(a.split('=', 1)[1])
    elif a.startswith('--rows='):
      rows = int(a.split('=', 1)[1])
    elif a.startswith('--cols='):
      cols = int(a.split('=', 1)[1])
    else:
      keep.append(a)
  keep.append('--goals=1')  # the figure IS the goal wrapper's obs
  G, _ = parse_flags(keep)
  env = env_fn(G)()
  # reference seeds (viz_goal.py:22-25) so figures are comparable
  env.seed(1 if 'Urchin' in G.env else 15 if 'Luxo' in G.env else int(G.seed))
  img = goal_grid(env, rows, cols)

  outdir.mkdir(parents=True, exist_ok=True)
  path = outdir / f'{G.env}_goals.png'
  from PIL import Image
  Image.fromarray((255 * img).astype(np.uint8)).save(path)
  print('wrote', path)
  return path


if __name__ == '__main__':
  main()
