"""What decides `correct` for collection traffic: the last dispatch of the
window, as delivered, against the plain reference.

- `barrel_diff` (host path only): elements of the dispatch's host arrays
  that its native barrels, read back by the reference's decoder, do not
  reproduce; exact, so its limit is 0.
- `action_diff`: the largest gap between the actions the sampled episodes
  carry and the reference's draw of them from the dispatch's generator
  state; the same draws and arithmetic, so its limit is 0.
- `reset_gap`: the largest gap, over the sampled worlds, between the
  delivered observation of the reset pose (full_state and proprio, each
  normalised to [-1, 1]) and the reference's.
- `obs_gap_p50`: per sampled world, the largest observation gap over the
  first `check.steps` steps (the physics through the rollout megakernel and
  the observation glue); the median over the worlds (contact dynamics
  amplify rounding in a tail of worlds, so the tail is not compared).
- `frame_diff_p50`: per sampled world, the share of the LCD pixels of the
  first `check.steps` frames that differ from the reference's raster of its
  own poses; the median over the worlds.
The worlds are drawn from the seed. Numbers without a limit are printed
beside the compared ones, as readings.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import barrels, episodes


def sample(seed, batch, n):
  """`n` distinct world indices of a dispatch of `batch`, ascending, drawn
  from the seed."""
  rng = np.random.default_rng(abs(int(seed)))
  return np.sort(rng.choice(batch, size=min(n, batch), replace=False))


def delivered(ans, idx, steps):
  """The compared arrays of worlds idx as the user receives them, and the
  numbers that only the host path has. On the host path the arrays come
  from the barrels, read back by the reference's decoder."""
  if 'barrels' not in ans:
    return {k: ans[k] for k in ('action', 'full_state', 'proprio', 'lcd')}, {}
  traj, bs, W = ans['traj'], ans['barrel_size'], ans['lcd_w']
  B = traj['action'].shape[0]
  want = dict(traj)
  packed = want.pop('lcd')
  want['lcd'] = np.unpackbits(packed, axis=-1)[..., :W].astype(bool)
  read = [barrels.read(b) for b in ans['barrels']]
  diff = 0
  got = {}
  for k, v in want.items():
    parts = [r.get(k) for r in read]
    got[k] = v   # what the program delivered, where no barrel holds it
    if not parts or any(p is None or p.shape[1:] != v.shape[1:]
                        for p in parts):
      diff += v.size
      continue
    mine = np.concatenate(parts)
    n = min(len(mine), len(v))
    diff += int((mine[:n] != v[:n]).sum()) + (len(v) - n) * v[0].size
    got[k] = np.concatenate([mine[:n], v[n:]])
  out = {'action': got['action'][idx],
         'full_state': got['full_state'][idx, :steps],
         'proprio': got['proprio'][idx, :steps],
         'lcd': got['lcd'][idx, :steps]}
  return out, {'barrel_diff': float(diff)}


def numbers(got, ref):
  """The compared numbers and the readings of one dispatch's sample."""
  gap = np.maximum(
      np.abs(got['full_state'] - ref['full_state']).max(-1),
      np.abs(got['proprio'] - ref['proprio']).max(-1))         # (S, steps)
  gap = np.where(np.isnan(gap), np.inf, gap)
  world = gap.max(1)
  px = (got['lcd'] != ref['lcd']).mean(axis=(1, 2, 3))
  cmp = {'action_diff': float(np.abs(got['action'] - ref['action']).max()),
         'reset_gap': float(gap[:, 0].max()),
         'obs_gap_p50': float(np.median(world)),
         'frame_diff_p50': float(np.median(px))}
  seen = {'obs_gap_p90': float(np.quantile(world, 0.9)),
          'obs_gap_max': float(world.max()),
          'frame_diff_mean': float(px.mean()),
          'frame_diff_max': float(px.max())}
  return cmp, seen


def world(cfg, traffic, device='cpu'):
  """The reference's world of a configuration under a traffic's solver
  settings, on `device`."""
  from portbench.reference.env import World
  return World(dict(cfg, env_config=dict(cfg['env_config'],
                                         **traffic.get('env_config', {}))),
               device)


def judge(cfg, traffic, ans, seed, device, bf16=False):
  """(compared numbers, readings) of the window's last dispatch. With
  bf16=True the reference held in bfloat16 stands in the program's place:
  the control."""
  w = world(cfg, traffic, device)
  B = int(traffic['worlds'])
  chk = traffic['check']
  idx = sample(seed, B, int(chk['worlds']))
  steps = int(chk['steps'])
  ref = episodes.replay(w, ans['gen_state'], device, B, idx, steps)
  if bf16:
    got, extra = episodes.replay(w, ans['gen_state'], device, B, idx, steps,
                                 bf16=True), {}
  else:
    got, extra = delivered(ans, idx, steps)
  cmp, seen = numbers(got, ref)
  return dict(extra, **cmp), seen
