"""Model-quality table protocol (the port of research/scripts/model_table.sh;
reference: scripts/script.py:6-51 + kicker.py presets): per env, collect,
train the MultiStepArbiter, train each world model at the reference budgets
(encoders 3e4 iterations, video models 1e5, bs 32; kicker.py:19-51,
123-126), run the Evaler into logger.pkl, then metrics_table renders the
FVD/SSIM/PSNR/cosdist table.

    python -m boxlcd_tpu_torch.research.scripts.model_table \
        ["Urchin Luxo"] [WORKDIR] [VIDEO_ITRS] [ENC_ITRS] [--dry] \
        [--device=cpu]

Every phase is resumable as in the shell script (barrels, checkpoints and
logger.pkl files present are skipped); a failing phase stops the chain,
with no retry loop. --dry prints the command sequence. The shell script's
BENCH_MATRIX regeneration rider belongs to the JAX bench; the port's matrix
is `BENCH_MATRIX=1 python -m boxlcd_tpu_torch.bench`.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from boxlcd_tpu_torch.research.scripts.headline_rl import (
    MAIN, Phase, n_files, run_chain)

TABLE = 'boxlcd_tpu_torch.research.scripts.metrics_table'
MODELS = ('RSSM', 'FIT', 'FBT', 'FRNLD')


def model_flags(model, work, env):
  """kicker.py:57-79's presets; FBT and FRNLD over their encoders."""
  return {
      'RSSM': ['--nfilter=64', '--hidden_size=300', '--free_nats=0.01'],
      'FIT': ['--n_layer=2', '--n_head=4', '--n_embed=256',
              '--hidden_size=256'],
      'FBT': ['--n_layer=4', '--n_head=8', '--n_embed=512',
              '--hidden_size=512', f'--weightdir={work}/{env}/bvae'],
      'FRNLD': ['--n_layer=4', '--n_head=8', '--n_embed=512',
                '--hidden_size=512', f'--weightdir={work}/{env}/rnlda'],
  }[model]


def phases(envs, work, vid, enc):
  work = Path(work)
  out = []
  for env in envs:
    D = work / env
    # the reference's per-env video window/prompt (kicker.py:46-49)
    win, prm = (25, 1) if env == 'Dropbox' else (50, 3)
    enc_common = [MAIN, '--mode=train', f'--env={env}', f'--datadir={D}/data',
                  f'--total_itr={enc}', '--bs=32', '--window=5',
                  '--log_n=5000', '--device_dataset=1']
    out += [
        Phase(f'[{env}] collect',
              [MAIN, '--mode=collect', f'--env={env}', f'--logdir={D}/data',
               '--train_barrels=100', '--test_barrels=10',
               '--num_envs=4000', '--barrel_format=native'],
              skip=lambda D=D: n_files(D / 'data' / 'train') >= 100),
        # the reference arbiter preset (kicker.py:137)
        Phase(f'[{env}] arbiter',
              enc_common + ['--model=MultiStepArbiter',
                            f'--logdir={D}/arbiter', '--hidden_size=256',
                            '--nfilter=64'],
              skip=lambda D=D: (D / 'arbiter' /
                                'MultiStepArbiter.pkl').exists()),
        Phase(f'[{env}] BVAE (FBT dependency)',
              enc_common + ['--model=BVAE', f'--logdir={D}/bvae',
                            '--hidden_size=64', '--vqK=64', '--vqD=16',
                            '--nfilter=16'],
              skip=lambda D=D: (D / 'bvae' / 'BVAE.pkl').exists()),
        Phase(f'[{env}] RNLDA (FRNLD dependency)',
              enc_common + ['--model=RNLDA', f'--logdir={D}/rnlda',
                            '--hidden_size=64', '--vqK=64', '--vqD=8',
                            '--nfilter=16'],
              skip=lambda D=D: (D / 'rnlda' / 'RNLDA.pkl').exists()),
    ]
    for M in MODELS:
      ev = work / 'eval' / M / env
      out += [
          Phase(f'[{env}] train {M}',
                [MAIN, '--mode=train', f'--model={M}', f'--env={env}',
                 f'--datadir={D}/data', f'--logdir={D}/{M}',
                 f'--total_itr={vid}', '--bs=32', f'--window={win}',
                 f'--prompt_n={prm}', '--log_n=20000', '--device_dataset=1',
                 *model_flags(M, work, env)],
                skip=lambda D=D, M=M: (D / M / f'{M}.pkl').exists()),
          # eval bs=256: the Evaler pools a fixed eval_n samples, so the
          # batch size changes only the dispatch granularity
          Phase(f'[{env}] eval {M}',
                [MAIN, '--mode=eval', f'--model={M}', f'--env={env}',
                 f'--datadir={D}/data', f'--weightdir={D}/{M}',
                 f'--arbiterdir={D}/arbiter', f'--logdir={ev}', '--bs=256',
                 f'--window={win}', f'--prompt_n={prm}'],
                skip=lambda ev=ev: (ev / 'logger.pkl').exists()),
      ]
  out += [Phase('metrics table',
                [TABLE, f'--logdir={work}/eval', f'--models={",".join(MODELS)}',
                 f'--envs={",".join(envs)}']),
          Phase(f'model_table complete: {work}', None)]
  return out


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('envs', nargs='?', default='Dropbox Bounce Urchin Luxo')
  p.add_argument('work', nargs='?', default='/tmp/mtable')
  p.add_argument('vid', nargs='?', type=int, default=100_000)
  p.add_argument('enc', nargs='?', type=int, default=30_000)
  p.add_argument('--dry', action='store_true')
  p.add_argument('--device', default=None,
                 help='passed to every training and eval command')
  args = p.parse_args(argv)
  Path(args.work).mkdir(parents=True, exist_ok=True)
  chain = phases(args.envs.split(), args.work, args.vid, args.enc)
  if args.device:
    for ph in chain:
      if ph.argv is not None and ph.argv[0] == MAIN:
        ph.argv = ph.argv + [f'--device={args.device}']
  return run_chain(chain, args.dry)


if __name__ == '__main__':
  main()
