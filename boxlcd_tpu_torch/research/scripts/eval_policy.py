"""Policy success evaluation: N=1000 episodes on the real sim — the headline
protocol (the port of research/scripts/eval_policy.py; reference:
research/scripts/evaluations/eval_policy.py:44-71, README.md:121): success
= done before timeout.

    python -m boxlcd_tpu_torch.research.scripts.eval_policy ppo|sac \
        --logdir=<the training run's logdir> [--device=cpu]

Rebuilds the algo from the checkpoint's G (on the real env: lenv=0,
mesh='', fused_rollout=0; the command line's logdir, seed,
test_deterministic, algo and device win), writes logdir/eval_policy.pkl
and an evidence JSON into EVIDENCE_DIR.
"""
from __future__ import annotations

import hashlib
import json
import pickle
import time
from pathlib import Path

import numpy as np

from boxlcd_tpu_torch.research.define_config import env_fn
from boxlcd_tpu_torch.research.rl._base import goal_mode_for, to_numpy
from boxlcd_tpu_torch.research.rl.main import parse
from boxlcd_tpu_torch.research.wrappers import VecEnv
from boxlcd_tpu_torch.utils import AttrDict, set_tf32

# 10 iters x 100 batched envs = the reference's N=1000 protocol (reference
# ran 100 iters x 10 process-envs)
N_ENVS = 100
ITERS = 10
# the committed evidence folder (.gitignore keeps logs/evidence/)
EVIDENCE_DIR = Path(__file__).resolve().parents[3] / 'logs' / 'evidence'
CLI_KEYS = ('logdir', 'seed', 'test_deterministic', 'algo', 'device')


def evaluate(G, get_a):
  env0 = env_fn(G)()
  raw = env0._env if hasattr(env0, '_env') else env0
  venv = VecEnv(raw, N_ENVS, G, goal_mode=goal_mode_for(G), seed=G.seed)
  successes = []
  for it in range(ITERS):
    o = venv.reset()
    succeeded = np.zeros(N_ENVS, bool)
    ep_done = np.zeros(N_ENVS, bool)
    for t in range(G.ep_len):
      # reference protocol: eval_policy.py:51 runs ac.step -> pi.sample()
      # (stochastic), so the published 0.999/0.988 numbers are sampled-action
      # success rates; --test_deterministic=1 opts into the mean action
      a = to_numpy(get_a(o, deterministic=bool(
          G.get('test_deterministic', 0))))
      o, rew, done, infos = venv.step(a)
      succ = np.array([i.get('success', False) for i in infos])
      succeeded |= (succ & ~ep_done)
      ep_done |= np.asarray(done)
      if ep_done.all():
        break
    successes.append(succeeded)
    print(f'iter {it + 1}/{ITERS}: running success '
          f'{np.concatenate(successes).mean():.3f}')
  rate = np.concatenate(successes).mean()
  print(f'SUCCESS RATE over {ITERS * N_ENVS} episodes: {rate:.3f}')
  return rate


def main(argv=None):
  """Evaluate the checkpoint in --logdir; returns the success rate."""
  set_tf32(False)
  G = parse(argv)
  ckpt = Path(G.logdir) / f'{G.algo}.pkl'
  # rebuild the algo with the CHECKPOINT's config (reference pattern: loaders
  # pop the smuggled G and reconstruct the model with it — evaler.py:34-41)
  if ckpt.exists():
    with open(ckpt, 'rb') as f:
      saved = pickle.load(f).get('G', {})
    merged = {**dict(G), **dict(saved), **{k: G[k] for k in CLI_KEYS}}
    # eval always runs on the REAL sim
    trained_lenv = int(merged.get('lenv', 0) or 0)
    merged.update(lenv=0, mesh='', fused_rollout=0)
    G = AttrDict(merged)
    G.logdir = Path(G.logdir)
    G.trained_lenv = trained_lenv
  if G.algo == 'ppo':
    from boxlcd_tpu_torch.research.rl.ppo import PPO
    algo = PPO(G)
  else:
    from boxlcd_tpu_torch.research.rl.sac import SAC
    algo = SAC(G)
  if ckpt.exists():
    algo.load(G.logdir)
  else:
    print(f'WARNING: no checkpoint at {ckpt}; evaluating the fresh policy')
  rate = evaluate(G, algo.get_a)
  out = Path(G.logdir) / 'eval_policy.pkl'
  out.parent.mkdir(parents=True, exist_ok=True)
  with open(out, 'wb') as f:
    pickle.dump({'success_rate': float(rate)}, f)
  # durable in-tree evidence: every headline number must trace back to a
  # committed artifact in EVIDENCE_DIR
  EVIDENCE_DIR.mkdir(parents=True, exist_ok=True)
  digest = (hashlib.sha256(ckpt.read_bytes()).hexdigest()[:16]
            if ckpt.exists() else None)
  ev = {
      'protocol': 'eval_policy N=1000 real-sim success',
      'env': str(G.env), 'algo': str(G.algo),
      'trained_in': 'learned_sim' if int(G.get('trained_lenv', 0) or 0) else
                    'real_sim',
      'success_rate': float(rate), 'episodes': N_ENVS * ITERS,
      'seed': int(G.seed),
      'total_steps': int(G.get('total_steps', 0)),
      'num_envs': int(G.get('num_envs', 0)),
      'vel_iters': int(G.get('vel_iters', 0)),
      'pos_iters': int(G.get('pos_iters', 0)),
      'device': str(G.device),
      'checkpoint': str(ckpt), 'checkpoint_sha256_16': digest,
      'time': time.strftime('%Y-%m-%d %H:%M:%S'),
  }
  # the run directory is in the name, so two evals of the same
  # env/algo/config cannot clobber each other's evidence
  name = (f"eval_{G.env}_{G.algo}_{ev['trained_in']}"
          f"_v{ev['vel_iters']}p{ev['pos_iters']}"
          f"_{Path(G.logdir).parent.name}_{Path(G.logdir).name}.json")
  with open(EVIDENCE_DIR / name, 'w') as f:
    json.dump(ev, f, indent=1)
  print('EVIDENCE', EVIDENCE_DIR / name)
  return rate


if __name__ == '__main__':
  try:
    main()
  except BaseException:
    # a pipeline that keeps only the last lines of the output hides
    # tracebacks: persist the error beside the run
    import sys
    import traceback
    for a in sys.argv:
      if a.startswith('--logdir='):
        with open(Path(a.split('=', 1)[1]) / 'eval_error.log', 'a') as f:
          f.write(traceback.format_exc() + '\n')
        break
    raise
