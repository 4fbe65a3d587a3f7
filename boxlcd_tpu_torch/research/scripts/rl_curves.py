"""Plot RL training curves from TensorBoard event scalars or dumped CSVs
(the port of research/scripts/rl_curves.py; reference:
research/scripts/evaluations/csv/plot.py).

    python -m boxlcd_tpu_torch.research.scripts.rl_curves \
        --runs real=<logdir> dream=<logdir> [--tag=test/success_rate]

A host tool: it reads the event files that the port's writer
(`research.utils.make_writer`) leaves where tensorboard is installed, else
`<tag with / as _>.csv` files of (step, value), and draws the figure with
matplotlib. Without matplotlib `main` raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def load_scalars(logdir, tag):
  """[(step, value)] of `tag` under logdir: TensorBoard events if
  tensorboard is installed and holds the tag, else the CSV, else []."""
  try:
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
  except ImportError:
    EventAccumulator = None
  if EventAccumulator is not None and Path(logdir).is_dir():
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    if tag in acc.Tags().get('scalars', []):
      return [(e.step, e.value) for e in acc.Scalars(tag)]
  csv = Path(logdir) / f'{tag.replace("/", "_")}.csv'
  if csv.exists():
    rows = [line.strip().split(',') for line in open(csv)][1:]
    return [(int(s), float(v)) for s, v in rows]
  return []


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--runs', nargs='+', required=True,
                      help='label=logdir pairs')
  parser.add_argument('--tag', default='test/success_rate')
  parser.add_argument('--out', default='rl_curves.png')
  args = parser.parse_args(argv)
  try:
    import matplotlib
  except ImportError as e:
    raise RuntimeError('rl_curves draws with matplotlib, which is not '
                       'installed here (a host tool: run it where it is)') \
        from e
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt
  plt.figure(figsize=(7, 4))
  for run in args.runs:
    label, logdir = run.split('=', 1)
    data = load_scalars(logdir, args.tag)
    if not data:
      print(f'no data for {label} at {logdir}')
      continue
    xs, ys = zip(*data)
    plt.plot(xs, ys, label=f'{label} (*{ys[-1]:.3f})')
  plt.xlabel('env steps')
  plt.ylabel(args.tag)
  plt.legend()
  plt.tight_layout()
  plt.savefig(args.out, dpi=120)
  plt.close()
  print('wrote', args.out)
  return args.out


if __name__ == '__main__':
  main()
