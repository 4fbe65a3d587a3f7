"""Trajectory-divergence metrics of the port's physics against the pybox2d
oracle (the port of tests/parity.py; SURVEY §7).

Pointwise long-horizon comparison of chaotic contact dynamics is
meaningless; the contract is (a) how LONG trajectories stay pointwise-close
(time-to-epsilon divergence) and (b) whether the engines visit the same
distribution of poses over whole episodes (per-dimension Wasserstein-1 on
body origin positions). The seeds of one env step as one batch of worlds
through the port's plain step (`physics.step_world_batch`), each beside its
own Box2D world. Shared by research/scripts/parity_table.py and the tests.
"""
from __future__ import annotations

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.envs.env import Env

# half an LCD pixel at 16 px over a 5 m world (5/16/2)
EPS_DIVERGE = 0.16


def make_env(name, G=None, device='cpu'):
  """Zoo env by name, or a bare-morphology world (walker/gingy/octo/spider
  have no zoo env class of their own; the reference exercises them via
  world_defs only)."""
  if name in boxlcd_tpu_torch.env_map:
    return boxlcd_tpu_torch.env_map[name](G, device=device)
  from boxlcd_tpu_torch.envs.env import WorldEnv
  from boxlcd_tpu_torch.world_defs import ROBOT_FILLER, Robot, WorldDef
  if name.lower() not in ROBOT_FILLER:
    raise KeyError(f'no env or morphology {name!r}')
  w = WorldDef(robots=[Robot(type=name.lower(), name=f'{name.lower()}0')],
               objects=[])
  G = dict(G or {})
  G.setdefault('wh_ratio', 2.0)
  G.setdefault('ep_len', 100)
  return WorldEnv(w, G, device=device)


def seeded_resets(env, seeds):
  """One world a seed, each reset from a generator seeded with it, as one
  batch on env's device."""
  rows = [Env.reset(env, torch.Generator(device=env.device).manual_seed(
      int(s)), 1) for s in seeds]
  return physics.WorldState(*(torch.cat(x) for x in zip(*rows)))


def _config(iters, G_extra):
  G = {'vel_iters': iters[0], 'pos_iters': iters[1]} if iters else {}
  G.update(G_extra or {})
  return G


def rollout_pairs(env_name, steps, seeds, actuated=True, iters=None,
                  G_extra=None, states=None):
  """Roll the port's engine and the Box2D oracle from identical poses, one
  world per seed, the port's worlds as one batch.

  Each seed's actions are numpy's RandomState(seed) uniforms, as in
  tests/parity.py. `states`: the initial WorldState of the batch (one row
  a seed), e.g. the JAX package's resets; default: `seeded_resets`.
  Returns, per seed, (ours, theirs): lists of (origin_positions (N, 2),
  angles (N,)). On the CPU: the oracle is a host library."""
  from boxlcd_tpu_torch.oracle import Box2DOracle
  env = make_env(env_name, _config(iters, G_extra), 'cpu')
  spec = env.spec
  if states is None:
    states = seeded_resets(env, seeds)
  oracles = []
  origin = physics.origin_pos(spec, states).numpy()
  for i in range(len(seeds)):
    o = Box2DOracle(env)
    o.reset_from(origin[i], states.a[i].numpy(), states.is_circle[i].numpy())
    oracles.append(o)
  rngs = [np.random.RandomState(int(s)) for s in seeds]
  out = [([], []) for _ in seeds]
  for _ in range(steps):
    act = np.stack([
        rng.uniform(-1, 1, env.act_size).astype(np.float32) if actuated
        else np.zeros(env.act_size, np.float32) for rng in rngs])
    states = physics.step_world_batch(spec, states, torch.as_tensor(act))
    pos = physics.origin_pos(spec, states).numpy()
    ang = states.a.numpy()
    for i, o in enumerate(oracles):
      o.step(act[i])
      out[i][0].append((pos[i], ang[i].copy()))
      out[i][1].append(o.poses())
  return out


def rollout_pair(env_name, steps, seed=0, actuated=True, iters=None,
                 G_extra=None, state=None):
  """rollout_pairs for one seed; `state` a batch-of-one WorldState."""
  return rollout_pairs(env_name, steps, [seed], actuated, iters, G_extra,
                       state)[0]


def divergence_metrics(ours, theirs, eps=EPS_DIVERGE):
  """{'t_eps', 'mean_err', 'w1_pose'} for one trajectory pair."""
  errs = np.array([np.abs(o[0] - t[0]).max() for o, t in zip(ours, theirs)])
  over = np.nonzero(errs > eps)[0]
  t_eps = int(over[0]) if len(over) else len(errs)
  # per-dimension Wasserstein-1 between the pose clouds visited over the
  # episode (pooled over steps, per body per coordinate), in meters
  a = np.stack([o[0] for o in ours])     # (T, N, 2)
  b = np.stack([t[0] for t in theirs])
  w1 = np.mean([
      np.abs(np.sort(a[:, n, d]) - np.sort(b[:, n, d])).mean()
      for n in range(a.shape[1]) for d in range(2)])
  return {'t_eps': t_eps, 'mean_err': float(errs.mean()),
          'w1_pose': float(w1)}


def env_parity(env_name, steps, seeds, actuated=True, iters=None,
               G_extra=None, states=None):
  """Divergence metrics averaged over seeds (one batch of worlds)."""
  rows = [divergence_metrics(ours, theirs) for ours, theirs in rollout_pairs(
      env_name, steps, list(seeds), actuated, iters, G_extra, states)]
  return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
