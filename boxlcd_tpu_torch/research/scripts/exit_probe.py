"""Velocity Gauss-Seidel convergence and NGS completion at the reference's
solver iterations (180/60): the probe that decides a solver exit (the port
of research/scripts/exit_probe.py).

A convergence exit (spec.solver_exit_tol) stops a world's velocity sweeps
once a sweep's largest |impulse delta| drops below the tolerance; the
port's kernels decide it per world, a tile-granular exit (the JAX TPU
kernel's) for a whole tile. Its value hinges on the distribution of
sweeps-to-convergence. This probe runs the port's plain step
(engine/physics.py) with the velocity stage instrumented: every sweep's
`dm` (`_vel_sweep(..., track=True)`, the quantity the exit tests), every
NGS iteration's Box2D done flag (`_position_solve(..., record_done=True)`)
and the wall and pair block activity, for every world, substep and step.
It reports, per tolerance:
  - per-world sweeps-to-tol percentiles (a per-world exit),
  - max-over-batch sweeps-to-tol (what a batch-granular exit pays),
  - the rebound rate (a sweep above tol after one below it),
then the residual decay profile, NGS sweeps-to-done, and the share of
(body, wall) and pair blocks active anywhere in the batch.

    python -m boxlcd_tpu_torch.research.scripts.exit_probe [Urchin] [B] [T] \
        [--device=cpu]

Defaults: Urchin, B = 64, T = 20 steps, at 180/60; on the card unless
--device=cpu.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.parity import make_env, seeded_resets


def probe_step(spec, states, actions):
  """step_world_batch with the solver stages instrumented. Returns (states',
  dms (substeps, B, vel_iters), dones (substeps, B, pos_iters),
  wall activity (substeps, n, nw), pair activity (substeps, P))."""
  K = physics.consts(spec, states.c.device)
  motor_speed = physics.motor_speeds(spec, actions)
  motor_changed = (motor_speed != states.prev_motor) & K.j_valid
  all_dms, all_dones, all_w, all_p = [], [], [], []
  for _ in range(spec.substeps):
    bundle, aux = physics._presolve(spec, K, states, motor_speed)
    carry = [x.clone() for x in (bundle.v, bundle.w, bundle.j_imp,
                                 bundle.j_mot, bundle.j_lim, bundle.wc,
                                 bundle.pc)]
    dms = [physics._vel_sweep(spec, bundle, carry, track=True)
           for _ in range(spec.vel_iters)]
    v, w, j_imp, j_mot, j_lim, wc, pc = carry
    bundle = bundle._replace(v=v, w=w, j_imp=j_imp, j_mot=j_mot, j_lim=j_lim,
                             wc=wc, pc=pc)
    c, a, dones = physics._position_solve(spec, states, bundle, aux,
                                          record_done=True)
    states = physics._finalize(spec, K, states, bundle, aux, motor_changed,
                               c, a)
    # per-(body, wall) block activity: would a batch-granular slot skip run
    # this block? (touch OR a carried warm-start impulse anywhere in B)
    warm = (bundle.wc[..., 0].abs() + bundle.wc[..., 1].abs()) > 0
    w_act = (aux.wallm.touch.any(-1) | warm.any(-1)).any(0)     # (n, nw)
    p_act = aux.pairm.touch.any(-1).any(0) | (
        bundle.pc.abs().sum((-1, -2)) > 0).any(0)                # (P,)
    all_dms.append(torch.stack(dms, 1))
    all_dones.append(dones)
    all_w.append(w_act)
    all_p.append(p_act)
  states = states._replace(ep_t=states.ep_t + 1, prev_motor=motor_speed)
  host = lambda xs: torch.stack(xs).cpu().numpy()
  return states, host(all_dms), host(all_dones), host(all_w), host(all_p)


def probe(env, states, T, seed=0):
  """T instrumented steps from `states` with numpy RandomState(seed)
  uniform actions. Returns (dms (T, substeps, B, iters), dones (T,
  substeps, B, pos_iters), w_act (T, substeps, n, nw), p_act (T, substeps,
  P))."""
  B = states.c.shape[0]
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(T):
    act = rng.uniform(-1, 1, (B, env.act_size)).astype(np.float32)
    states, *rec = probe_step(env.spec, states,
                              torch.as_tensor(act, device=env.device))
    out.append(rec)
  return tuple(np.stack(x) for x in zip(*out))


def report(env_name, spec, dms, dones, w_act, p_act):
  """Print the percentile report; returns its numbers."""
  T, _, B, iters = dms.shape
  flat = dms.reshape(-1, B, iters)            # (T*substeps, B, iters)
  out = {'tol': {}}
  print(f'== {env_name} {spec.vel_iters}/{spec.pos_iters}, B={B}, T={T} '
        f'steps x {spec.substeps} substeps')
  for tol, name in [(1e-3, '1e-3'), (1e-4, '1e-4'), (1e-5, '1e-5'),
                    (0.0, 'exact-0')]:
    # sweeps executed under the exit: first i with dm[i] <= tol, +1
    below = flat <= tol if tol > 0 else flat == 0.0
    first = np.where(below.any(-1), below.argmax(-1) + 1, iters)
    # once below, does it STAY below? (monotone tail => exit is safe)
    rebound = ((~below) & (np.cumsum(below, -1) > 0)).any(-1)
    per_world = first.ravel()
    tile_max = first.max(1)                   # max over B per substep
    print(f' tol {name:8s} per-world p50/p90/max: '
          f'{np.percentile(per_world, 50):6.1f} '
          f'{np.percentile(per_world, 90):6.1f} {per_world.max():4d}'
          f' | tile(max over B) mean/p90/max: {tile_max.mean():6.1f} '
          f'{np.percentile(tile_max, 90):6.1f} {tile_max.max():4d}'
          f' | rebound {rebound.mean():.3f}')
    out['tol'][name] = dict(p50=float(np.percentile(per_world, 50)),
                            p90=float(np.percentile(per_world, 90)),
                            max=int(per_world.max()),
                            tile_mean=float(tile_max.mean()),
                            rebound=float(rebound.mean()))
  # residual decay profile: median/p90 dm across the batch at sample sweeps
  med = np.median(flat, axis=(0, 1))
  p90 = np.percentile(flat, 90, axis=(0, 1))
  mx = flat.max((0, 1))
  for i in [0, 1, 3, 7, 15, 31, 63, 119, 179]:
    if i < iters:
      print(f'  sweep {i:3d}: median dm {med[i]:.3e}  p90 {p90[i]:.3e}  '
            f'max {mx[i]:.3e}')
  # NGS: iterations until the Box2D done flag (its exit is exact, so the
  # tile's all-done is the trip count a tile-granular exit pays)
  pi = dones.shape[-1]
  dflat = dones.reshape(-1, B, pi)
  first = np.where(dflat.any(-1), dflat.argmax(-1) + 1, pi)
  tile_all = first.max(1)
  print(f' NGS done per-world p50/p90/max: '
        f'{np.percentile(first, 50):5.1f} {np.percentile(first, 90):5.1f} '
        f'{first.max():3d} | tile(max over B) mean/p90/max: '
        f'{tile_all.mean():5.1f} {np.percentile(tile_all, 90):5.1f} '
        f'{tile_all.max():3d} (of {pi})')
  out['ngs'] = dict(p50=float(np.percentile(first, 50)),
                    p90=float(np.percentile(first, 90)),
                    max=int(first.max()), tile_mean=float(tile_all.mean()))
  # batch-granular slot-skip payoff: the share of (body, wall) velocity
  # blocks a batch must run (touch or warm impulse anywhere in B)
  frac = w_act.reshape(-1, *w_act.shape[2:]).mean(0)          # (n, nw)
  print(f' wall blocks active (any over B={B}): mean {frac.mean():.3f}')
  for wi in range(frac.shape[1]):
    print(f'  wall {wi}: per-body any-active rate '
          + ' '.join(f'{frac[i, wi]:.2f}' for i in range(frac.shape[0])))
  out['wall_active'] = float(frac.mean())
  if p_act.shape[-1]:
    pf = p_act.reshape(-1, p_act.shape[-1]).mean(0)
    print(' pair blocks active: ' + ' '.join(f'{v:.2f}' for v in pf))
    out['pair_active'] = pf.tolist()
  return out


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('env', nargs='?', default='Urchin')
  p.add_argument('B', nargs='?', type=int, default=64)
  p.add_argument('T', nargs='?', type=int, default=20)
  p.add_argument('--device', default=None)
  args = p.parse_args(argv)
  device = utils.resolve_device(args.device)
  env = make_env(args.env, {'vel_iters': 180, 'pos_iters': 60}, device)
  t0 = time.perf_counter()
  # world i from a generator seeded i (the JAX probe seeds its env with i)
  recs = probe(env, seeded_resets(env, range(args.B)), args.T)
  sec = time.perf_counter() - t0
  out = report(args.env, env.spec, *recs)
  out['seconds'] = sec
  print(f' probed {args.T} steps in {sec:.2f} s on {device}')
  return out


if __name__ == '__main__':
  main()
