#!/usr/bin/env python3
"""Sweep launcher: one command template fanned over envs with per-model
hyperparameter presets (the port of research/scripts/kicker.py; reference:
research/scripts/kicker.py). The commands run the port's CLI,
`python -m boxlcd_tpu_torch.research.main`.

    python -m boxlcd_tpu_torch.research.scripts.kicker --model=BVAE \
        --envs=0 [--dry] [--extra='--device=cpu --total_itr=100']

`--models=A,B,...` fans the same flags over several models, one after the
other (research/scripts/all_model_test.sh's loop): FBT and FRNLD still need
their encoder's checkpoints in --weightdir.
"""
from __future__ import annotations

import argparse
import subprocess
from collections import defaultdict
from pathlib import Path

from boxlcd_tpu_torch.utils import AttrDict

TIER0 = ['Dropbox', 'Bounce', 'Bounce2', 'Object2']
TIER1 = ['Urchin', 'Luxo', 'UrchinCube', 'LuxoCube', 'UrchinBall', 'LuxoBall']
ALL = TIER0 + TIER1
ENVS = {'all': ALL, '0': TIER0, '1': TIER1}

# per-model presets (reference: kicker.py:17-87)
MultiStepArbiter = AttrDict(total_itr=int(3e4))
BVAE = AttrDict(hidden_size=64, vqK=64, vqD=16, nfilter=16, window=5,
                total_itr=int(3e4))
RNLDA = AttrDict(hidden_size=64, vqK=64, vqD=8, nfilter=16, window=5,
                 total_itr=int(3e4))
RSSM = AttrDict(nfilter=64, hidden_size=300, free_nats=0.01,
                total_itr=int(1e5))
FIT = AttrDict(n_layer=2, n_head=4, n_embed=256, hidden_size=256,
               total_itr=int(1e5))
FBT = AttrDict(n_layer=4, n_head=8, n_embed=512, hidden_size=512,
               total_itr=int(1e5))
FRNLD = AttrDict(n_layer=4, n_head=8, n_embed=512, hidden_size=512,
                 total_itr=int(1e5))
PRESETS = {'MultiStepArbiter': MultiStepArbiter, 'BVAE': BVAE, 'RNLDA': RNLDA,
           'RSSM': RSSM, 'FIT': FIT, 'FBT': FBT, 'FRNLD': FRNLD}

ENV_WINDOW = defaultdict(lambda: 50)
ENV_WINDOW['Dropbox'] = 25
ENV_PROMPT = defaultdict(lambda: 3)
ENV_PROMPT['Dropbox'] = 1

MODULE = 'boxlcd_tpu_torch.research.main'


def commands(args, model):
  """The argv lists of one model's sweep."""
  preset = PRESETS.get(model, AttrDict())
  cmds = []
  for env in ENVS.get(args.envs, [args.envs]):
    cmd = ['python', '-m', MODULE, '--mode=train',
           f'--model={model}', f'--env={env}',
           f'--datadir={Path(args.datadir) / env}',
           f'--logdir={Path(args.logdir) / model / env}',
           f'--bs={args.bs}', f'--lr={args.lr}',
           f'--window={ENV_WINDOW[env]}', f'--prompt_n={ENV_PROMPT[env]}']
    for k, v in preset.items():
      cmd.append(f'--{k}={v}')
    if args.weightdir:
      cmd.append(f'--weightdir={Path(args.weightdir) / env}')
    if args.arbiterdir:
      cmd.append(f'--arbiterdir={Path(args.arbiterdir) / env}')
    if args.extra:
      cmd.extend(args.extra.split())
    cmds.append(cmd)
  return cmds


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--envs', default='all', help='all | 0 | 1 | name')
  parser.add_argument('--model', default='BVAE')
  parser.add_argument('--models', default='',
                      help='comma list: run each model sweep in turn')
  parser.add_argument('--datadir', default='logs/data')
  parser.add_argument('--logdir', default='logs/kick')
  parser.add_argument('--weightdir', default='')
  parser.add_argument('--arbiterdir', default='')
  parser.add_argument('--bs', default='32')
  parser.add_argument('--lr', default='5e-4')
  parser.add_argument('--dry', action='store_true')
  parser.add_argument('--extra', default='', help='extra flags passthrough')
  args = parser.parse_args(argv)

  for model in (args.models.split(',') if args.models else [args.model]):
    procs = []
    for cmd in commands(args, model):
      print(' '.join(cmd), flush=True)
      if not args.dry:
        procs.append(subprocess.Popen(cmd))
    for p in procs:
      if p.wait() != 0:
        raise SystemExit(f'kicker: {p.args} exited {p.returncode}')


if __name__ == '__main__':
  main()
