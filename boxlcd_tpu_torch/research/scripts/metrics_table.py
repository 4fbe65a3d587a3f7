"""Build the model-quality metric table from the Evaler's pickles (the port
of research/scripts/metrics_table.py; reference:
research/scripts/script.py:6-51, the FVD/SSIM/PSNR/cosdist LaTeX table per
env x model).

    python -m boxlcd_tpu_torch.research.scripts.metrics_table \
        --logdir=<eval root> [--models=RSSM,FIT,FBT,FRNLD] [--envs=...]

Reads <logdir>/<model>/<env>/logger.pkl, the port Evaler's table
({'<split>:<u|p>:<metric>': (mean, std)}), and prints LaTeX rows.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

METRICS = ['fvd', 'ssim', 'psnr', 'cosdist']


def table(logdir, models, envs, split='test'):
  """The LaTeX rows, as one string."""
  rows = []
  header = ['env'] + [f'{m}/{x}' for m in models for x in METRICS]
  rows.append(' & '.join(header) + r' \\')
  for env in envs:
    cells = [env]
    for model in models:
      pkl = Path(logdir) / model / env / 'logger.pkl'
      if pkl.exists():
        with open(pkl, 'rb') as f:
          tab = pickle.load(f)
        # keys are '<split>:<u|p>:<metric>' -> (mean, std); the paper table
        # uses the prompted test metrics (reference: scripts/script.py:30-42)
        res = {k.split(':', 2)[2]: v for k, v in tab.items()
               if k.startswith(f'{split}:p:')}
        for metric in METRICS:
          if metric in res:
            m, s = res[metric]
            cells.append(f'{m:.3f}$\\pm${s:.3f}')
          else:
            cells.append('--')
      else:
        cells.extend(['--'] * len(METRICS))
    rows.append(' & '.join(cells) + r' \\')
  return '\n'.join(rows)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--logdir', default='logs/eval')
  parser.add_argument('--models', default='RSSM,FIT,FBT,FRNLD')
  parser.add_argument('--envs', default='Dropbox,Bounce,Urchin,Luxo')
  parser.add_argument('--split', default='test')
  args = parser.parse_args(argv)
  out = table(args.logdir, args.models.split(','), args.envs.split(','),
              args.split)
  print(out)
  return out


if __name__ == '__main__':
  main()
