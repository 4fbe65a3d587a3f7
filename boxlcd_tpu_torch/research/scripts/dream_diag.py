"""Dream-environment diagnostic: evaluate ANY saved PPO policy INSIDE the
learned simulator, the fused RewardLenv(LearnedEnv) rollout (the port of
research/scripts/dream_diag.py).

Separates "the dream env caps success" from "dream PPO optimizes slowly":
run a policy that converged in the real sim in the dream. If its in-dream
success is high, the model and its serving are fine and the gap is
optimization; if low, the dream dynamics or reward disagree with the real
sim (model error, decode bias, or the token-sampling temperature).

    python -m boxlcd_tpu_torch.research.scripts.dream_diag ppo \
        --logdir=<ppo ckpt dir> --weightdir=<FBT dir> --env=Luxo \
        [--diag_epochs=3] [--diag_random=1] [--lenv_temp=1.0] [--device=cpu]

The checkpoint's G gives the net shapes; the command line wins for the
dream-env knobs (logdir, seed, algo, weightdir, env, lenv_temp, num_envs,
steps_per_epoch, window, goal_thresh) and the device. Each epoch is one
`PPO.lenv_rollout` of steps_per_epoch / num_envs fused dream steps. The
success metric matches PPO's in-train `success_rate`: episodes end on
goal-reach or the (lockstep) timeout; rate = goal-reach ends / all ends.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np

from boxlcd_tpu_torch.research.rl.main import parse
from boxlcd_tpu_torch.utils import AttrDict

CLI_KEYS = ('logdir', 'seed', 'algo', 'weightdir', 'env', 'lenv_temp',
            'num_envs', 'steps_per_epoch', 'window', 'goal_thresh', 'device')


def merged_config(G):
  """JAX's merge (dream_diag.py:43-54): the CLI's G, the checkpoint's over
  it, the CLI_KEYS over that; a fused dream epoch on the FBT."""
  with open(Path(G.logdir) / 'ppo.pkl', 'rb') as f:
    saved = pickle.load(f).get('G', {})
  cli = {k: G[k] for k in CLI_KEYS}
  merged = {**dict(G), **dict(saved), **cli}
  merged.update(lenv=1, mesh='', model='FBT', fused_rollout=1, lenv_test=0)
  G = AttrDict(merged)
  for p in ('logdir', 'datadir', 'weightdir', 'arbiterdir', 'buffdir'):
    G[p] = Path(G[p])
  return G


def tally(traj):
  """(episodes ended, successes, mean reward) of one epoch's trajectory
  (obs, a, rew, v, logp, done, success)."""
  _, _, rew, _, _, done, succ = [np.asarray(x) for x in traj]
  return int(done.sum()), int(succ.sum()), float(rew.mean())


def diagnose(algo, epochs, draws=None, state=None):
  """`epochs` fused dream epochs from `state` (wb, ptr, ep_t, goals), by
  default the learned env's reset; draws[e], if given, are epoch e's draws
  (`PPO.lenv_rollout`). Prints a line an epoch and the rate; returns
  (rate, episodes, successes, mean rewards)."""
  if state is None:
    algo.env.reset()
    lenv = algo.env.lenv
    state = (lenv.window_batch, lenv.ptr, lenv.ep_t, dict(algo.env.goal))
  tot_s = tot_d = 0
  rews = []
  for ep in range(epochs):
    wb, ptr, ep_t, goals, traj, _ = algo.lenv_rollout(
        *state, algo.steps_per_epoch,
        draws=None if draws is None else draws[ep])
    state = (wb, ptr, ep_t, goals)
    d, s, r = tally(traj)
    tot_s += s
    tot_d += d
    rews.append(r)
    print(f'epoch {ep + 1}/{epochs}: eps={d} succ={s} running_rate='
          f'{tot_s / max(tot_d, 1):.3f} mean_rew={r:.4f}', flush=True)
  return tot_s / max(tot_d, 1), tot_d, tot_s, rews


def main(argv=None):
  argv = list(sys.argv[1:] if argv is None else argv)
  diag_epochs = 3
  diag_random = False
  keep = []
  for a in argv:
    if a.startswith('--diag_epochs='):
      diag_epochs = int(a.split('=', 1)[1])
    elif a.startswith('--diag_random='):
      diag_random = bool(int(a.split('=', 1)[1]))
    else:
      keep.append(a)
  G = merged_config(parse(keep))

  from boxlcd_tpu_torch.research.rl.ppo import PPO
  algo = PPO(G)
  if diag_random:
    print('RANDOM-POLICY control: fresh init, no checkpoint loaded')
  else:
    algo.load(G.logdir)
  algo._build_fused_lenv()
  algo.gen.manual_seed(int(G.seed) + 777)
  rate, tot_d, _, _ = diagnose(algo, diag_epochs)
  print(f'IN-DREAM SUCCESS RATE over {tot_d} episodes: {rate:.3f} '
        f'(temp={G.lenv_temp}, ckpt={Path(G.logdir) / "ppo.pkl"})')
  return rate


if __name__ == '__main__':
  main()
