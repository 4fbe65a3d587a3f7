"""Headline benchmark of the port: batched env steps/s on the card (Urchin
at 4096 worlds), the counterpart of the repo's bench.py.

    python -m boxlcd_tpu_torch.bench

Times the data-collection hot path: physics, the LCD render and the full
observation (lcd, full_state and proprio, every one summed so nothing is
skipped), K chunks of T steps queued back to back with one
torch.cuda.synchronize() at the end, the best of `iters` repeats. Prints
ONE JSON line with bench.py's keys and metric name, plus the card's name
and power limit (nvidia-smi). Runs on the card unless BENCH_DEVICE=cpu (or
main(device='cpu')). Baseline: the reference collects ~1.7k env-steps/s on
one CPU process (examples/README.md:33, at its 180/60 solver iterations).

Env vars (bench.py's, with its defaults):
  BENCH_WORLDS / BENCH_STEPS   batch size (4096) / chunk length (0: ep_len)
  BENCH_ENV                    env name (Urchin)
  BENCH_ITERS=ref              the reference's 180/60 solver iterations (else
                               8/4)
  BENCH_EXIT_TOL               the solver's convergence exit (0.0)
  BENCH_SOLVER=auto|mega|jnp|sub
      mega  the rollout megakernel (csrc/mega_rollout.cu) for the T steps,
            then the trajectory raster (csrc/traj_raster.cu), the rows
            unpacked to frames, and observe_pose;
      sub   a step at a time with the substep-solver kernel
            (csrc/batched_solver.cu) in step_world_batch, then Env.observe
            (the lcd raster kernel, csrc/lcd_raster.cu);
      jnp   the same with the plain step;
      auto  mega on the card where engine/mega.supports(spec), else jnp.
  BENCH_PALLAS=1               BENCH_SOLVER=sub
  BENCH_PIPELINE               chunks queued before the one sync (4)
  BENCH_TRAJ_RASTER=0          mega: frames from observe_pose's per-frame
                               raster instead of the trajectory raster
  BENCH_RASTER                 'exact' (default) or 'fast'
  BENCH_MATRIX=1               also measure the {iters} x {solver} x {env}
                               matrix into MATRIX_PATH, the port's own file
                               (logs/evidence/torch/BENCH_MATRIX.json);
                               BENCH_MATRIX_ENVS picks the envs
  BENCH_MEGA_SMOKE=1           build and run the megakernel on Urchin,
                               LuxoCube and Object3 first (the card only)

A kernel that fails raises: nothing falls back to another solver or to the
CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from pathlib import Path

import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.engine import cuda_solver, mega, physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import raster, traj_raster

REFERENCE_STEPS_PER_SEC = 1700.0  # examples/README.md:33 (CPU, single proc)
MATRIX_PATH = (Path(__file__).resolve().parents[1] / 'logs' / 'evidence'
               / 'torch' / 'BENCH_MATRIX.json')
# (vel_iters, pos_iters, solver, exit_tol) rows of the matrix, per env
MATRIX_CONFIGS = ((8, 4, 'auto', 0.0), (180, 60, 'auto', 0.0),
                  (180, 60, 'auto', 1e-4), (8, 4, 'jnp', 0.0))
MEGA_SMOKE_WORLDS = 128


def make_env(env_name, vel_iters, pos_iters, device, exit_tol=None):
  return boxlcd_tpu_torch.env_map[env_name](
      {'vel_iters': vel_iters, 'pos_iters': pos_iters,
       'solver_exit_tol': float(os.environ.get('BENCH_EXIT_TOL', 0.0))
       if exit_tol is None else exit_tol,
       'raster': os.environ.get('BENCH_RASTER', 'exact')}, device=device)


def resolve_kind(env, solver_kind):
  """auto -> mega on the card where the megakernel supports the spec,
  else jnp."""
  if solver_kind != 'auto':
    return solver_kind
  return ('mega' if env.device.type == 'cuda' and mega.supports(env.spec)
          else 'jnp')


def make_chunk(env, solver_kind, T):
  """chunk(states, actions (T, B, act)) -> (states, consumed): T env steps
  with their full observations, every part summed into `consumed`."""
  spec = env.spec
  if solver_kind == 'mega':
    # the datagen fast path: one megakernel launch runs all T steps, then
    # one trajectory-raster launch renders the (T, B) frames from its pose
    # stream, and observe_pose packs the rest in one vectorised pass
    rollout = mega.make_rollout(spec, T)
    use_tr = (traj_raster.supports(spec) and env.lcd_w <= 32
              and str(env.G.get('raster', 'exact')) == 'exact'
              and bool(int(os.environ.get('BENCH_TRAJ_RASTER', '1'))))
    trender = (traj_raster.make_traj_render(spec, env.lcd_w, env.lcd_h)
               if use_tr else None)

    def chunk(states, actions):
      ms = physics.motor_speeds(spec, actions).contiguous()
      states, traj = rollout(states, ms)
      poses = traj['stream']                                  # (T, n, 3, B)
      ic, cs, as_ = mega.flat_poses(poses, states.is_circle)
      if trender is not None:
        lcd = raster.unpack_rows(trender.rows(poses, states.is_circle),
                                 env.lcd_w)
        obs = env.observe_pose(ic, cs, as_, lcd=False)
        return states, (lcd.sum() + obs['full_state'].sum()
                        + obs['proprio'].sum())
      obs = env.observe_pose(ic, cs, as_)
      return states, (obs['lcd'].sum() + obs['full_state'].sum()
                      + obs['proprio'].sum())
    return chunk

  if solver_kind not in ('sub', 'jnp'):
    raise ValueError(f'unknown BENCH_SOLVER {solver_kind!r}')
  solver = cuda_solver.make_substep_solver(spec) if solver_kind == 'sub' \
      else None

  def chunk(states, actions):
    """T env steps, each with its observation (lcd render + packing)."""
    consumed = torch.zeros((), device=states.c.device)
    for t in range(T):
      states = physics.step_world_batch(spec, states, actions[t],
                                        substep_solver=solver)
      obs = Env.observe(env, states)
      consumed = (consumed + obs['lcd'].sum() + obs['full_state'].sum()
                  + obs['proprio'].sum())
    return states, consumed
  return chunk


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def measure(env_name, vel_iters, pos_iters, solver_kind, B, T, iters=3,
            exit_tol=None, device=None):
  """env-steps/s for one config, the best of `iters` pipelines of K chunks;
  returns (steps_per_sec, solver_used)."""
  device = utils.resolve_device(device)
  env = make_env(env_name, vel_iters, pos_iters, device, exit_tol)
  solver_kind = resolve_kind(env, solver_kind)
  chunk = make_chunk(env, solver_kind, T)
  gen = torch.Generator(device=device).manual_seed(0)
  states = Env.reset(env, gen, B)

  def actions():
    return torch.rand((T, B, env.act_size), generator=gen,
                      device=device) * 2 - 1

  states, s = chunk(states, actions())        # warm: build and first run
  if not torch.isfinite(s):
    raise RuntimeError(f'{env_name} {solver_kind}: non-finite observations')
  # steady state, as collection dispatches: K chunks queued back to back
  # (each consumes the previous one's states) and one sync at the end
  K = int(os.environ.get('BENCH_PIPELINE', 4))
  best = 0.0
  for _ in range(iters):
    _sync(device)
    t0 = time.perf_counter()
    st = states
    for _ in range(K):
      st, s = chunk(st, actions())
    _sync(device)
    best = max(best, K * B * T / (time.perf_counter() - t0))
    if not torch.isfinite(s):
      raise RuntimeError(f'{env_name} {solver_kind}: non-finite observations')
  return best, solver_kind


def mega_smoke(device=None):
  """Build and run the rollout megakernel on the card for one env of each
  contact-manifold class (robot self-pairs, robot + object pairs, random
  shapes) at T = 4; raises on any failure. Returns 'Urchin:ok,...'."""
  device = utils.resolve_device(device)
  results = []
  for ename in ('Urchin', 'LuxoCube', 'Object3'):
    env = boxlcd_tpu_torch.env_map[ename]({}, device=device)
    spec = env.spec
    if not mega.supports(spec):
      raise RuntimeError(f'mega smoke: {ename} is not supported')
    T, B = 4, MEGA_SMOKE_WORLDS
    states = Env.reset(env, torch.Generator(device=device).manual_seed(0), B)
    ms = torch.zeros((T, B, len(spec.j_parent)), device=device)
    _, traj = mega.make_rollout(spec, T)(states, ms)
    if not torch.isfinite(traj['stream'].sum()):
      raise RuntimeError(f'mega smoke: {ename} gave non-finite poses')
    results.append(f'{ename}:ok')
  result = ','.join(results)
  print(f'mega compile smoke: {result}', flush=True)
  return result


def card_line(device):
  """nvidia-smi's name and power limit of the card, or 'cpu'."""
  if device.type != 'cuda':
    return 'cpu'
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
       f'--id={device.index or 0}'],
      capture_output=True, text=True, timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


def run_matrix(B, T, device):
  """The env x {iters, solver, exit tol} matrix into MATRIX_PATH, written
  after every row; rows of envs not measured now are kept from the file."""
  menvs = os.environ.get('BENCH_MATRIX_ENVS',
                         'Urchin,LuxoCube,Object3,Bounce2').split(',')
  kept = []
  if MATRIX_PATH.exists():
    kept = [r for r in json.loads(MATRIX_PATH.read_text())
            if r['env'] not in menvs]
  rows = []
  MATRIX_PATH.parent.mkdir(parents=True, exist_ok=True)
  for ename in menvs:
    for vi, pi, kind, tol in MATRIX_CONFIGS:
      if kind == 'jnp' and any(
          r['env'] == ename and r['vel_iters'] == vi
          and r['pos_iters'] == pi and r['solver'] == 'jnp'
          and r['exit_tol'] == tol for r in rows):
        continue  # an auto row already ran this exact jnp config
      sps, solver_used = measure(ename, vi, pi, kind, B, T, exit_tol=tol,
                                 device=device)
      rows.append({'env': ename, 'vel_iters': vi, 'pos_iters': pi,
                   'solver': solver_used, 'exit_tol': tol, 'worlds': B,
                   'steps_per_sec': round(sps, 1)})
      print(rows[-1], flush=True)
      MATRIX_PATH.write_text(json.dumps(kept + rows, indent=1))
  return rows


def main(device=None, iters=3):
  """The headline line (returned as a dict and printed as JSON), the best
  of `iters` pipelines."""
  device = utils.resolve_device(device or os.environ.get('BENCH_DEVICE'))
  B = int(os.environ.get('BENCH_WORLDS', 4096))
  env_name = os.environ.get('BENCH_ENV', 'Urchin')
  # default chunk length = the env's episode length: what mega-collect
  # dispatches per launch during collection (one episode per world)
  T = int(os.environ.get('BENCH_STEPS', 0)) or \
      int(boxlcd_tpu_torch.env_map[env_name]({}, device='cpu').G.ep_len)
  ref_iters = os.environ.get('BENCH_ITERS', '') == 'ref'
  vel, pos = (180, 60) if ref_iters else (8, 4)
  solver_kind = os.environ.get('BENCH_SOLVER', 'auto')
  if int(os.environ.get('BENCH_PALLAS', 0)):
    solver_kind = 'sub'
  if int(os.environ.get('BENCH_MATRIX', 0)):
    run_matrix(B, T, device)
  smoke = None
  if int(os.environ.get('BENCH_MEGA_SMOKE', 1)) and device.type == 'cuda':
    smoke = mega_smoke(device)
  steps_per_sec, solver_used = measure(env_name, vel, pos, solver_kind, B,
                                       T, iters=iters, device=device)
  suffix = '_ref_iters' if ref_iters else ''
  if float(os.environ.get('BENCH_EXIT_TOL', 0.0)) > 0.0:
    suffix += '_exit'
  if os.environ.get('BENCH_RASTER', 'exact') != 'exact':
    suffix += '_fastraster'
  rec = {
      'metric': f'env_steps_per_sec_{env_name.lower()}_{B}{suffix}',
      'value': round(steps_per_sec, 1),
      'unit': 'env-steps/s',
      'vs_baseline': round(steps_per_sec / REFERENCE_STEPS_PER_SEC, 2),
      'solver': solver_used,
      'card': card_line(device),
  }
  if smoke is not None:
    rec['mega_smoke'] = smoke
  print(json.dumps(rec), flush=True)
  return rec


if __name__ == '__main__':
  main()
