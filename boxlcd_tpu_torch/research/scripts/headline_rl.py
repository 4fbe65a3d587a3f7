"""Headline RL transfer protocol (the port of research/scripts/headline_rl.sh;
reference README.md:111-139, BASELINE.md rows 1-4): PPO trained in the real
sim vs PPO trained inside the learned sim (FBT), both evaluated on the real
sim at N = 1000 episodes.

    python -m boxlcd_tpu_torch.research.scripts.headline_rl [ENV] [WORKDIR] \
        [PPO_STEPS] [--dry] [--device=cpu]

Seven phases through the port's CLIs (research.main, research.rl.main,
scripts.eval_policy), each resumable as in the shell script: collection
skips with 100 train barrels present, the BVAE and FBT with their
checkpoints, the PPO runs with their `done` files (and resume from
ppo_last.pkl). A failing phase stops the chain: there is no retry loop.
--dry prints the command sequence and runs nothing.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

MAIN = 'boxlcd_tpu_torch.research.main'
RL = 'boxlcd_tpu_torch.research.rl.main'
EVAL = 'boxlcd_tpu_torch.research.scripts.eval_policy'


class Phase:
  """One step of a chain: `argv` after `python -m`, run unless `skip()`;
  `after()` runs once it succeeded; `tail` prints only that many of its
  last output lines."""

  def __init__(self, label, argv, skip=lambda: False, after=None, tail=0):
    self.label, self.argv, self.skip = label, argv, skip
    self.after, self.tail = after, tail


def run_chain(phases, dry=False, extra=()):
  """Run each phase in order (or print it with dry); raises on the first
  failure. Returns the argv lists, `python -m` included."""
  cmds = []
  for ph in phases:
    print(f'=== {ph.label}', flush=True)
    if ph.argv is None:
      continue
    cmd = [sys.executable, '-m', *ph.argv, *extra]
    cmds.append(cmd)
    if dry:
      print(' '.join(['python'] + cmd[1:]), flush=True)
      continue
    if ph.skip():
      print('(done already: skipped)', flush=True)
      continue
    if ph.tail:
      out = subprocess.run(cmd, check=True, capture_output=True, text=True)
      print('\n'.join(out.stdout.splitlines()[-ph.tail:]), flush=True)
    else:
      subprocess.run(cmd, check=True)
    if ph.after is not None:
      ph.after()
  return cmds


def n_files(path):
  path = Path(path)
  return len(list(path.iterdir())) if path.is_dir() else 0


def phases(env, work, ppo_steps):
  work = Path(work)
  touch = lambda p: (lambda: (work / p).touch())
  ppo = ['ppo', f'--env={env}', '--goals=1', '--autoreset=1',
         '--num_envs=128', f'--total_steps={ppo_steps}',
         '--steps_per_epoch=48000', '--bs=4096', '--hidden_size=256',
         '--test_n=2', '--resume=1']
  return [
      Phase(f'[1/7] collect {env}',
            [MAIN, '--mode=collect', f'--env={env}',
             f'--logdir={work}/data', '--train_barrels=100',
             '--test_barrels=10', '--num_envs=4000',
             '--barrel_format=native'],
            skip=lambda: n_files(work / 'data' / 'train') >= 100),
      # kicker preset hyperparams (reference: kicker.py:19-26)
      Phase('[2/7] BVAE',
            [MAIN, '--mode=train', '--model=BVAE', f'--env={env}',
             f'--datadir={work}/data', f'--logdir={work}/bvae',
             '--total_itr=30000', '--bs=32', '--window=5', '--log_n=5000',
             '--device_dataset=1', '--hidden_size=64', '--vqK=64',
             '--vqD=16', '--nfilter=16'],
            skip=lambda: (work / 'bvae' / 'BVAE.pkl').exists()),
      Phase('[3/7] FBT',
            [MAIN, '--mode=train', '--model=FBT', f'--env={env}',
             f'--datadir={work}/data', f'--weightdir={work}/bvae',
             f'--logdir={work}/fbt', '--total_itr=100000', '--bs=32',
             '--window=25', '--n_embed=512', '--n_head=8', '--n_layer=4',
             '--log_n=20000', '--device_dataset=1'],
            skip=lambda: (work / 'fbt' / 'FBT.pkl').exists()),
      # reference headline budgets (research/scripts/README.md:138-147):
      # epoch = 48000 transitions, bs=4096 minibatches, 256-wide nets, as
      # 128 batched envs x 375 steps an epoch
      Phase('[4/7] PPO in the REAL sim',
            [RL, *ppo, '--lenv=0', f'--logdir={work}/ppo_real'],
            skip=lambda: (work / 'ppo_real' / 'done').exists(),
            after=touch('ppo_real/done')),
      Phase('[5/7] eval PPO(real) on real sim, N=1000',
            [EVAL, 'ppo', f'--env={env}', '--goals=1',
             f'--logdir={work}/ppo_real'], tail=3),
      Phase('[6/7] PPO in the LEARNED sim (FBT)',
            [RL, *ppo, '--lenv=1', '--model=FBT', f'--weightdir={work}/fbt',
             '--lenv_test=0', f'--logdir={work}/ppo_lenv'],
            skip=lambda: (work / 'ppo_lenv' / 'done').exists(),
            after=touch('ppo_lenv/done')),
      Phase('[7/7] eval PPO(lenv) on real sim, N=1000',
            [EVAL, 'ppo', f'--env={env}', '--goals=1',
             f'--logdir={work}/ppo_lenv'], tail=3),
      Phase(f'chain complete: {work}', None),
  ]


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('env', nargs='?', default='Luxo')
  p.add_argument('work', nargs='?', default=None)
  # the reference's --total_steps=500000 counts VECTOR steps of 12 envs
  # (ppo.py:127) => 6M transitions; the port's total_steps counts
  # transitions
  p.add_argument('ppo_steps', nargs='?', type=int, default=6_000_000)
  p.add_argument('--dry', action='store_true')
  p.add_argument('--device', default=None,
                 help='passed to every command (the card by default)')
  args = p.parse_args(argv)
  work = Path(args.work or f'/tmp/headline_{args.env}')
  work.mkdir(parents=True, exist_ok=True)
  extra = [f'--device={args.device}'] if args.device else []
  return run_chain(phases(args.env, work, args.ppo_steps), args.dry, extra)


if __name__ == '__main__':
  main()
