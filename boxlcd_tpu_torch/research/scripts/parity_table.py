"""The physics-parity table of the port against pybox2d: time-to-epsilon
divergence, episode mean error and pose-distribution Wasserstein-1, per env
at the default (8/4) and the reference's (180/60) solver iterations (the
port of research/scripts/parity_table.py; reference stepping:
boxLCD/world_env.py:446-452; SURVEY §7).

    python -m boxlcd_tpu_torch.research.scripts.parity_table \
        [--envs=Dropbox,Urchin] [--steps=50] [--seeds=3] [--out=rows.json]

A host tool on the CPU (pybox2d is not on the card's host; it raises
without it). The seeds of an env step as one batch through the port's plain
step: ~0.2 s a step at 8/4 and ~4-5 s at 180/60 on one CPU thread.
"""
from __future__ import annotations

import argparse
import json

from boxlcd_tpu_torch import oracle
from boxlcd_tpu_torch.parity import env_parity

PASSIVE = {'Dropbox', 'Bounce', 'Bounce2', 'Object2', 'Object3'}
ITERS = ((8, 4), (180, 60))


def rows_for(envs, steps, seeds):
  if not oracle.HAVE_BOX2D:
    raise RuntimeError('parity_table needs pybox2d (import Box2D failed)')
  rows = []
  for env_name in envs:
    for it in ITERS:
      m = env_parity(env_name, steps, seeds=range(seeds),
                     actuated=env_name not in PASSIVE, iters=it)
      row = {'env': env_name, 'iters': f'{it[0]}/{it[1]}', **m}
      rows.append(row)
      print(row, flush=True)
  return rows


def markdown(rows):
  out = ['| env | iters | t_eps (steps) | mean err (m) | W1 pose (m) |',
         '|---|---|---|---|---|']
  for r in rows:
    out.append(f"| {r['env']} | {r['iters']} | {r['t_eps']:.1f} | "
               f"{r['mean_err']:.3f} | {r['w1_pose']:.3f} |")
  return '\n'.join(out)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('--envs', default='Dropbox,Bounce,Object3,Urchin,Luxo,'
                 'Crab,Walker,Gingy,Octo,Spider')
  p.add_argument('--steps', type=int, default=50)
  p.add_argument('--seeds', type=int, default=3)
  p.add_argument('--out', default='')
  args = p.parse_args(argv)
  rows = rows_for(args.envs.split(','), args.steps, args.seeds)
  print('\n' + markdown(rows))
  if args.out:
    with open(args.out, 'w') as f:
      json.dump(rows, f, indent=1)
  return rows


if __name__ == '__main__':
  main()
