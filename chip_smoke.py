#!/usr/bin/env python3
"""Smoke run of boxlcd_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure raises and the script exits non-zero:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under boxlcd_tpu_torch/csrc/ with nvcc, in
     parallel, printing each build's seconds and ptxas' register, stack and
     spill lines;
  3. lcd raster vs plain: the per-frame LCD raster kernel against its plain
     torch version, bit for bit, on Urchin, LuxoCube, Object3 and Bounce2 at
     B = 1000, 4096 and 262144, from reset states after 3 plain-physics steps
     and from random poses that put bodies partly outside the frame; then
     its times at the tripwire's 16 frames and at 4000+ worlds;
  4. traj raster vs plain: the trajectory raster kernel against its plain
     version, bit for bit, on the same envs, from megakernel pose streams
     and from random poses across the frame's edges, up to T x B = 64 x 4096
     = 262144 frames, and at the main path's shape (100 x 4000), where it is
     then timed;
  5. megakernel vs plain: tests/test_mega.py's six envs at B = 1024, T = 34
     (4 random-action steps, then 30 zero-action steps) within that file's
     per-field median and tail bounds, poses at t = 0 and 2 within 1e-4, the
     sleep share within 0.02; then the same at the main path's shape
     (Urchin, 4000 worlds x 100 random-action steps), where it is timed;
  6. reference: the per-step core on the card against the CPU, and the
     megakernel path against the per-step path on the card from one seed
     (equal actions, t = 0 frames equal bit for bit);
  7. main path: `fill_barrels` for Urchin (vel_iters 8, pos_iters 4, 4000
     worlds = 4 barrels in one dispatch, 100 steps, 16x32 LCD) through the
     megakernel path, with every kernel's launch count set to 0 just before
     and read just after (megakernel 1, traj raster 1, lcd raster 1 for the
     tripwire); the barrels must load and hold finite, non-blank data. Then
     the device's busy share of a whole call and the per-layer times of one
     dispatch;
  8. per-step path: `fill_barrels` with collect_mega=0 at 1000 worlds x 25
     steps (the lcd raster launches once a step), and the per-layer times of
     one step at 4000 worlds.

Prints the card line and the kernels' JSON line before the last line, which
is {"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. --out writes the measurements as JSON as well.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import _build
from boxlcd_tpu_torch.data.collect import (
    fill_barrels, make_mega_rollout_fn, make_rollout_fn, pack_bits)
from boxlcd_tpu_torch.data.dataset import BARREL_SIZE, RolloutDataset
from boxlcd_tpu_torch.engine import mega, physics
from boxlcd_tpu_torch.engine.spec import CIRCLE
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import cuda_raster, raster, traj_raster
from boxlcd_tpu_torch.utils import AttrDict

ITERS = {'vel_iters': 8, 'pos_iters': 4}     # bench.py's headline setting
CHECK_ENVS = [('Urchin', 32, 16), ('LuxoCube', 24, 16), ('Object3', 16, 16),
              ('Bounce2', 16, 16)]
CHECK_BATCHES = [1000, 4096, 262144]
MAIN_ENV, MAIN_BATCH, MAIN_BARRELS = 'Urchin', 4000, 4
TRIPWIRE_FRAMES = 16                        # the main path's lcd raster call
TRAJ_SHAPES = [(2, 1000), (64, 4096)]       # (T, B), up to 262144 frames
PER_STEP_BATCH, PER_STEP_T = 1000, 25       # the per-step path, cut in depth
MEGA_CHECK_B, MEGA_CHECK_T = 1024, 34       # tests/test_mega.py's shape
# tests/test_mega.py's FIELDS and BOUNDS: (median, tail threshold, tail
# fraction, least sleep share of the plain version)
MEGA_FIELDS = ['c', 'a', 'v', 'w', 'sleep_time', 'wc_imp', 'j_imp', 'j_mot',
               'j_lim', 'j_state', 'prev_motor', 'pc_imp', 'pc_id']
MEGA_BOUNDS = {
    'Urchin': (1e-4, 5e-3, 0.03, 0.2),
    'Luxo': (1e-4, 5e-3, 0.03, 0.2),
    'LuxoCube': (1e-4, 5e-3, 0.03, 0.2),
    'UrchinBall': (1e-4, 5e-3, 0.03, 0.2),
    'Bounce2': (1e-4, 5e-3, 0.03, None),
    'Object3': (1.5e-3, 5e-2, 0.2, None),
}
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
FP32_FLOPS = 67e12                          # H100 SXM, outside the tensor cores


def log(*args):
  print(*args, flush=True)


def card_phase():
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  log(smi.splitlines()[0])
  log(f'torch {torch.__version__} cuda {torch.version.cuda} '
      f'device {torch.cuda.get_device_name(0)} '
      f'count {torch.cuda.device_count()}')
  # the physics has no matrix products; state the setting all the same
  torch.backends.cuda.matmul.allow_tf32 = False
  return smi.splitlines()[0]


def build_phase():
  t0 = time.time()
  info = _build.build_all()
  log(f'[build] {sorted(info)} in {time.time() - t0:.2f} s')
  for name, rec in sorted(info.items()):
    log(f'[build] {name}: nvcc {rec["seconds"]:.2f} s')
    for line in rec['log'].splitlines():
      if 'ptxas' in line and ('registers' in line or 'spill' in line
                              or 'stack' in line or 'Compiling' in line):
        log(f'[build] {name}: {line.strip()}')
  return {n: r['seconds'] for n, r in info.items()}


def _env(name, dev, **G):
  return boxlcd_tpu_torch.env_map[name](dict(ITERS, **G), device=dev)


def _stepped_poses(env, batch, gen):
  """Reset states after 3 plain-physics steps of random actions."""
  st = Env.reset(env, gen, batch)
  for _ in range(3):
    act = torch.rand((batch, env.act_size), generator=gen,
                     device=st.c.device) * 2 - 1
    st = physics.step_world_batch(env.spec, st, act)
  return st.is_circle, st.c, st.a


def _random_poses(env, batch, gen):
  """Uniform poses over 1.5x the world, so bodies cross the frame's edges."""
  s = env.spec
  dev = env.device
  st = Env.reset(env, gen, batch)
  u = torch.rand((batch, s.n, 3), generator=gen, device=dev)
  c = torch.stack([(u[..., 0] * 1.5 - 0.25) * s.width,
                   (u[..., 1] * 1.5 - 0.25) * s.height], -1)
  return st.is_circle, c, (u[..., 2] * 2 - 1) * math.pi


def wall_ms(fn, n):
  """Host-clock ms per call of fn, warm, ending in a synchronize: what a
  caller pays, the host's dispatch included."""
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(n):
    fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3 / n


def events_ms(fn, n):
  """Device ms per call of a function of few launches: CUDA events bracket
  n calls queued behind a GPU sleep that outlasts their enqueue, so the span
  holds device work only (n * launches must stay within the launch queue)."""
  host = wall_ms(fn, n) * n / 1e3
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(int((4 * host + 0.01) * 2e9))   # cycles at <= 2 GHz
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / n


def profiled_ms(fn, n):
  """Device ms per call from torch.profiler: the summed durations of the
  kernels fn launches (gaps between them excluded), or None when the
  profiler sees no device time."""
  fn()
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
  # only the device's own events: a CPU op's self device time repeats the
  # durations of the kernels it launched
  us = sum(e.device_time_total for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, 'is_user_annotation', False))
  return us / 1e3 / n if us > 0 else None


def _fmt(ms):
  return 'not measured' if ms is None else f'{ms:.4f} ms'


def raster_flops(spec, is_circle, height):
  """Float operations of one frame per world for these shape flags: per
  drawn polygon the b2Mul transform (8 + 10 per vertex), one divide per edge
  and an edge crossing (mul + add) per edge and row; per drawn circle its
  bbox (8)."""
  B, N = is_circle.shape
  shape = torch.as_tensor(spec.shape_static, device=is_circle.device)
  circ = (shape == 0) | ((shape == 2) & is_circle)
  nv = torch.as_tensor(spec.nverts, device=is_circle.device).double()
  poly_ops = 8 + 10 * nv + nv + 2 * nv * height
  return float(torch.where(circ, 8.0, poly_ops.expand(B, N)).sum())


def raster_bound(spec, is_circle, width, height, consts):
  """Least time of one raster call: (bound ms, 'bytes' | 'operations').

  Bytes: each input read once (is_circle, c, cos, sin and the per-spec
  constant tables), the (B, H) int32 rows written once. Operations:
  raster_flops."""
  B, N = is_circle.shape
  nbytes = (B * N * (1 + 8 + 4 + 4) + B * height * 4
            + sum(t.numel() * t.element_size() for t in consts.values()))
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = raster_flops(spec, is_circle, height) / FP32_FLOPS * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def kernel_phase(dev):
  """The per-frame raster kernel against its plain version, bit for bit."""
  gen = torch.Generator(device=dev).manual_seed(0)
  mismatches, max_err, n_frames = 0, 0, 0
  for name, W, H in CHECK_ENVS:
    env = _env(name, dev)
    render = cuda_raster.make_batched_render(env.spec, W, H)
    for kind, poses in (('stepped', _stepped_poses), ('random', _random_poses)):
      ic, c, a = poses(env, max(CHECK_BATCHES), gen)
      for B in CHECK_BATCHES:
        icb, cb = ic[:B].contiguous(), c[:B].contiguous()
        cosa, sina = torch.cos(a[:B]), torch.sin(a[:B])
        got = render.kernel_rows(icb, cb, cosa, sina)
        want = render.plain_rows(icb, cb, cosa, sina)
        torch.cuda.synchronize()
        bad = int((got != want).any(1).sum())
        err = int((raster.unpack_rows(got, W).int()
                   - raster.unpack_rows(want, W).int()).abs().max())
        frames = raster.unpack_rows(got, W)
        if frames.all() or not frames.any():
          raise RuntimeError(f'{name} {kind} B={B}: blank frames')
        log(f'[kernel] {name} {W}x{H} {kind} B={B}: {bad} of {B} frames '
            f'differ from the plain version')
        mismatches += bad
        max_err = max(max_err, err)
        n_frames += B
  if mismatches:
    raise RuntimeError(f'lcd_raster: {mismatches} frames differ from the '
                       f'plain version')

  # times at the main path's shape, and at 4096 and 262144 worlds
  env = _env(MAIN_ENV, dev)
  render = cuda_raster.make_batched_render(env.spec, env.lcd_w, env.lcd_h)
  times = {}
  for B in (TRIPWIRE_FRAMES, MAIN_BATCH, 4096, max(CHECK_BATCHES)):
    ic, c, a = _stepped_poses(env, B, gen)
    cosa, sina = torch.cos(a), torch.sin(a)
    kern = lambda: render.kernel_rows(ic, c, cosa, sina)
    plain = lambda: render.plain_rows(ic, c, cosa, sina)
    bound, by = raster_bound(env.spec, ic, env.lcd_w, env.lcd_h,
                             render.consts.tables(ic.device))
    t = times[B] = dict(
        ms=events_ms(kern, 100), prof_ms=profiled_ms(kern, 100),
        wall_ms=wall_ms(kern, 100), plain_prof_ms=profiled_ms(plain, 5),
        plain_wall_ms=wall_ms(plain, 5), bound_ms=bound, bound_by=by)
    # the plain version is many small launches: its device time is the sum
    # of their durations (profiler), or its wall time where that is unseen
    t['plain_ms'] = t['plain_prof_ms'] or t['plain_wall_ms']
    log(f'[kernel] {MAIN_ENV} B={B}: kernel {t["ms"]:.4f} ms device (events),'
        f' {_fmt(t["prof_ms"])} (profiler), {t["wall_ms"]:.4f} ms a call with '
        f'dispatch; plain {_fmt(t["plain_prof_ms"])} device (profiler), '
        f'{t["plain_wall_ms"]:.3f} ms a call; bound {bound:.6f} ms ({by})')
  return dict(mismatches=mismatches, max_abs_err=max_err, frames=n_frames,
              times=times)


def traj_bound(spec, is_circle, T, height, consts):
  """Least time of one trajectory-raster call: (bound ms, 'bytes' |
  'operations'). Bytes: the poses (x, y, angle), cos and sin of T frames,
  is_circle once per world and the spec tables read once, the (T, B, H)
  int32 rows written once. Operations: raster_bound's per-frame count, T
  times."""
  B, N = is_circle.shape
  nbytes = (T * B * N * (12 + 8) + B * N + T * B * height * 4
            + sum(t.numel() * t.element_size() for t in consts.values()))
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = T * raster_flops(spec, is_circle, height) / FP32_FLOPS * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def mega_flops_per_substep(spec, contacts):
  """Float operations of one world-substep of the megakernel, counted from
  csrc/physics_stages.cuh (adds, multiplies, divides, square roots; cosf and
  sinf as one each). V_i: polygon vertices of body i (0 for circles); C:
  touching contact points per world; vi, pi: velocity and position
  iterations; jn joints, P valid pairs, nw walls, R label rounds:
    sum_i (7 + 14 V_i)                 integrate, cos/sin, world polygon
  + nw * sum_i (5 V_i + 12)            wall narrowphase
  + sum_pairs (8 V_a V_b + 120)        pair narrowphase (SAT, clip, init)
  + C (45 + 45 vi + 35 pi)             contact init + warm start, sweeps, NGS
  + jn (60 + 87 vi + 55 pi)            joint init + warm start, sweeps, NGS
  + 10 n + 2 R (jn + P)                sleeping
  with pi = 1: the per-world NGS exit is not observed, so the count takes
  the fewest iterations the exit allows."""
  V = [0 if int(k) == CIRCLE else int(v)
       for k, v in zip(spec.shape_static, spec.nverts)]
  nw = len(spec.wall_offset)
  pairs = [(int(a), int(b)) for a, b, ok in
           zip(spec.pair_a, spec.pair_b, spec.pair_valid) if ok]
  rounds = max(1, int(np.ceil(np.log2(max(spec.n, 2))))) + 1
  vi, pi = spec.vel_iters, 1
  return (sum(7 + 14 * v for v in V) + nw * sum(5 * v + 12 for v in V)
          + sum(8 * V[a] * V[b] + 120 for a, b in pairs)
          + contacts * (45 + 45 * vi + 35 * pi)
          + spec.jn * (60 + 87 * vi + 55 * pi)
          + 10 * spec.n + 2 * rounds * (spec.jn + len(pairs)))


def mega_bound(spec, final, B, T):
  """Least time of one megakernel call: (bound ms, 'bytes' | 'operations',
  flops). Operations: mega_flops_per_substep with C the contact points
  touching in the final state (this run's data), x substeps x T x B.
  Bytes: the WorldState read and written once, the (T, B, J) motor speeds
  read once, the (T, N, 3, B) pose stream written once."""
  contacts = float(((final.wc_id >= 0).sum() + (final.pc_id >= 0).sum()) / B)
  flops = (mega_flops_per_substep(spec, contacts) * spec.substeps * T * B)
  state = sum(getattr(final, f).numel() * getattr(final, f).element_size()
              for f in physics.WorldState._fields)
  nbytes = 2 * state + T * B * len(spec.j_parent) * 4 + T * spec.n * 3 * B * 4
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / FP32_FLOPS * 1e3
  by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
  return (*by, flops)


def once_ms(fn):
  """Host-clock ms of one call, ending in a synchronize (for calls long
  enough that one sample is the measurement)."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3


def _motor_speeds(env, acts):
  """(B, T, act) actions -> (T, B, J) contiguous motor speeds."""
  return physics.motor_speeds(env.spec, acts).transpose(0, 1).contiguous()


def traj_phase(dev):
  """The trajectory raster against its plain version, bit for bit."""
  gen = torch.Generator(device=dev).manual_seed(1)
  mismatches, n_frames = 0, 0
  for name, W, H in CHECK_ENVS:
    env = _env(name, dev)
    s = env.spec
    render = traj_raster.make_traj_render(s, W, H)
    for T, B in TRAJ_SHAPES:
      st = Env.reset(env, gen, B)
      acts = torch.rand((B, T, env.act_size), generator=gen, device=dev) * 2 - 1
      _, traj = mega.make_rollout(s, T).kernel_rollout(
          st, _motor_speeds(env, acts))
      u = torch.rand((T, s.n, 3, B), generator=gen, device=dev)
      rnd = torch.stack([(u[:, :, 0] * 1.5 - 0.25) * s.width,
                         (u[:, :, 1] * 1.5 - 0.25) * s.height,
                         (u[:, :, 2] * 2 - 1) * math.pi], 2)
      for kind, poses in (('megakernel', traj['stream']), ('random', rnd)):
        cosa, sina = torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])
        got = render.kernel_rows(poses, cosa, sina, st.is_circle)
        want = render.plain_rows(poses, cosa, sina, st.is_circle)
        torch.cuda.synchronize()
        bad = int((got != want).any(-1).sum())
        frames = raster.unpack_rows(got, W)
        if frames.all() or not frames.any():
          raise RuntimeError(f'{name} {kind} T={T} B={B}: blank frames')
        log(f'[traj] {name} {W}x{H} {kind} T={T} B={B}: {bad} of {T * B} '
            f'frames differ from the plain version')
        mismatches += bad
        n_frames += T * B
  if mismatches:
    raise RuntimeError(f'traj_raster: {mismatches} frames differ from the '
                       f'plain version')

  # times at the main path's shape: 100 frames of 4000 worlds
  env = _env(MAIN_ENV, dev)
  T = int(env.G.ep_len)
  render = traj_raster.make_traj_render(env.spec, env.lcd_w, env.lcd_h)
  st = Env.reset(env, gen, MAIN_BATCH)
  acts = torch.rand((MAIN_BATCH, T, env.act_size), generator=gen,
                    device=dev) * 2 - 1
  _, traj = mega.make_rollout(env.spec, T).kernel_rollout(
      st, _motor_speeds(env, acts))
  poses = traj['stream']
  cosa, sina = torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])
  kern = lambda: render.kernel_rows(poses, cosa, sina, st.is_circle)
  plain = lambda: render.plain_rows(poses, cosa, sina, st.is_circle)
  # the timed shape is checked too, bit for bit
  got, want = kern(), plain()
  torch.cuda.synchronize()
  bad = int((got != want).any(-1).sum())
  log(f'[traj] {MAIN_ENV} {env.lcd_w}x{env.lcd_h} megakernel T={T} '
      f'B={MAIN_BATCH}: {bad} of {T * MAIN_BATCH} frames differ from the '
      f'plain version')
  mismatches += bad
  n_frames += T * MAIN_BATCH
  if mismatches:
    raise RuntimeError(f'traj_raster: {bad} frames differ from the plain '
                       f'version at the main path\'s shape')
  bound, by = traj_bound(env.spec, st.is_circle, T, env.lcd_h,
                         render.consts.tables(dev))
  t = dict(ms=events_ms(kern, 20), prof_ms=profiled_ms(kern, 20),
           plain_prof_ms=profiled_ms(plain, 1), plain_wall_ms=wall_ms(plain, 1),
           bound_ms=bound, bound_by=by)
  t['plain_ms'] = t['plain_prof_ms'] or t['plain_wall_ms']
  log(f'[traj] {MAIN_ENV} T={T} B={MAIN_BATCH}: kernel {t["ms"]:.4f} ms '
      f'device (events), {_fmt(t["prof_ms"])} (profiler); plain '
      f'{_fmt(t["plain_prof_ms"])} device (profiler), '
      f'{t["plain_wall_ms"]:.2f} ms a call; bound {bound:.6f} ms ({by})')
  return dict(mismatches=mismatches, max_abs_err=0 if not mismatches else 1,
              frames=n_frames, times=t)


def _mega_check(label, B, bounds, new, traj, ref, ref_traj, worst,
                failures, sleep_min=None):
  """Hold one megakernel run to tests/test_mega.py's bounds of its plain
  version: per-world median and tail error of every field, poses at t = 0
  and 2 within 1e-4, sleep share within 0.02 (and the plain version's above
  sleep_min where given). Adds each field's worst world to `worst` and each
  breach to `failures`."""
  med_b, tail_at, tail_frac = bounds
  msg = []
  for f in MEGA_FIELDS:
    err = (getattr(ref, f).float() - getattr(new, f).float()).abs()
    err = err.reshape(B, -1).max(1).values
    med, tail = float(err.median()), float((err > tail_at).float().mean())
    worst[f] = max(worst.get(f, 0.0), float(err.max()))
    msg.append(f'{f} {med:.1e}/{tail:.3f}')
    if med >= med_b or tail >= tail_frac:
      failures.append(f'{label} {f}: median {med:.2e}, tail {tail:.3f}')
  pose_err = max(float((traj[k][t] - ref_traj[k][t]).abs().max())
                 for k in ('c', 'a') for t in (0, 2))
  if pose_err >= 1e-4:
    failures.append(f'{label}: poses at t=0/2 differ by {pose_err:.2e}')
  f_ref = float((ref.sleep_time > 0).float().mean())
  f_new = float((new.sleep_time > 0).float().mean())
  if abs(f_ref - f_new) >= 0.02 or (sleep_min is not None
                                    and f_ref <= sleep_min):
    failures.append(f'{label}: sleep share {f_new:.3f} vs {f_ref:.3f}')
  if not torch.isfinite(new.c).all():
    failures.append(f'{label}: non-finite poses')
  log(f'[mega] {label}: median/tail per field: {", ".join(msg)}; poses '
      f't=0/2 max err {pose_err:.2e}; sleep share {f_new:.3f} (plain '
      f'{f_ref:.3f})')


def mega_phase(dev):
  """The megakernel against its plain version on tests/test_mega.py's six
  envs and bounds, then at the main path's shape (Urchin, 4000 worlds x 100
  steps of fresh random actions): the plain call timed there is held to the
  same bounds. The least sleep share is not asked of it: it shows that the
  30 zero-action steps let worlds fall asleep, and the main path has none."""
  failures, worst = [], {}
  for name, (*bounds, sleep_min) in MEGA_BOUNDS.items():
    env = _env(name, dev)
    B, T = MEGA_CHECK_B, MEGA_CHECK_T   # 4 random-action steps, then zeros
    gen = torch.Generator(device=dev).manual_seed(2)
    st = Env.reset(env, gen, B)
    acts = torch.cat([torch.rand((B, 4, env.act_size), generator=gen,
                                 device=dev) * 2 - 1,
                      torch.zeros((B, T - 4, env.act_size), device=dev)], 1)
    rollout = mega.make_rollout(env.spec, T)
    ms = _motor_speeds(env, acts)
    new, traj = rollout.kernel_rollout(st, ms)
    ref, ref_traj = rollout.plain_rollout(st, ms)
    torch.cuda.synchronize()
    _mega_check(f'{name} B={B} T={T}', B, bounds, new, traj, ref, ref_traj,
                worst, failures, sleep_min)

  # the main path's shape: Urchin, 4000 worlds, 100 steps
  env = _env(MAIN_ENV, dev)
  T = int(env.G.ep_len)
  gen = torch.Generator(device=dev).manual_seed(3)
  st = Env.reset(env, gen, MAIN_BATCH)
  acts = torch.rand((MAIN_BATCH, T, env.act_size), generator=gen,
                    device=dev) * 2 - 1
  ms = _motor_speeds(env, acts)
  rollout = mega.make_rollout(env.spec, T)
  final, traj = rollout.kernel_rollout(st, ms)
  # the plain version is ~10^6 small launches: one call, timed on the host
  # clock (a profiler trace of it would not fit the run), and kept
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  ref, ref_traj = rollout.plain_rollout(st, ms)
  torch.cuda.synchronize()
  plain_wall = (time.perf_counter() - t0) * 1e3
  _mega_check(f'{MAIN_ENV} B={MAIN_BATCH} T={T}', MAIN_BATCH,
              MEGA_BOUNDS[MAIN_ENV][:3], final, traj, ref, ref_traj, worst,
              failures)
  stream_err = float((traj['stream'] - ref_traj['stream']).abs().max())
  log(f'[mega] {MAIN_ENV} B={MAIN_BATCH} T={T}: pose stream max err over '
      f'all steps {stream_err:.2e}')
  if failures:
    raise RuntimeError('megakernel outside the test_mega bounds:\n'
                       + '\n'.join(failures))
  bound, by, flops = mega_bound(env.spec, final, MAIN_BATCH, T)
  t = dict(ms=events_ms(lambda: rollout.kernel_rollout(st, ms), 3),
           plain_wall_ms=plain_wall, plain_ms=plain_wall, bound_ms=bound,
           bound_by=by, flops=flops, stream_err=stream_err)
  log(f'[mega] {MAIN_ENV} B={MAIN_BATCH} T={T}: kernel {t["ms"]:.3f} ms '
      f'device (events); plain {plain_wall:.1f} ms a call (host clock); '
      f'bound {bound:.6f} ms ({by}, {flops:.3e} flops)')
  return dict(max_abs_err=max(worst.values()), worst=worst, times=t)


def reference_phase(dev):
  """(a) The per-step rollout core on the card vs on the CPU from the same
  states and actions: full_state within tests/test_mega.py's Urchin bounds
  (median per-world error 1e-4, < 3% of worlds above 5e-3), >= 99.9% equal
  pixels. (b) The megakernel path vs the per-step path on the card from
  one generator seed: equal actions, t=0 frames equal bit for bit,
  full_state within the same bounds."""
  B, T = 64, 8
  env_cpu = _env(MAIN_ENV, 'cpu', ep_len=T)
  env_gpu = _env(MAIN_ENV, dev, ep_len=T)
  st = Env.reset(env_cpu, torch.Generator().manual_seed(1), B)
  acts = torch.rand((B, T, env_cpu.act_size),
                    generator=torch.Generator().manual_seed(2)) * 2 - 1
  want = make_rollout_fn(env_cpu)[0].core(st, acts)
  st_gpu = physics.state_from_numpy(physics.state_to_numpy(st), dev)
  got = make_rollout_fn(env_gpu)[0].core(st_gpu, acts.to(dev))
  fs, fs_ref = got['full_state'].cpu().numpy(), want['full_state'].numpy()
  if fs.shape != (B, T, env_cpu.obs_size) or not np.isfinite(fs).all():
    raise RuntimeError(f'full_state {fs.shape} is not finite or misshapen')
  err = np.abs(fs - fs_ref).reshape(B, -1).max(1)
  same = float((got['lcd'].cpu() == want['lcd']).float().mean())
  log(f'[reference] card vs CPU core, {MAIN_ENV} B={B} T={T}: full_state '
      f'median err {np.median(err):.2e}, worlds > 5e-3: '
      f'{(err > 5e-3).mean():.3f}, equal pixels {same:.5f}')
  if np.median(err) >= 1e-4 or (err > 5e-3).mean() >= 0.03 or same < 0.999:
    raise RuntimeError('the card disagrees with the CPU reference')

  step = make_rollout_fn(env_gpu)[0](torch.Generator(device=dev).manual_seed(5), B)
  meg = make_mega_rollout_fn(env_gpu)[0](
      torch.Generator(device=dev).manual_seed(5), B)
  ok = bool(meg.pop('obs_ok'))
  err_m = (step['full_state'] - meg['full_state']).abs().reshape(B, -1)
  err_m = err_m.max(1).values.cpu().numpy()
  t0_same = bool(torch.equal(step['lcd'][:, 0], meg['lcd'][:, 0]))
  act_same = bool(torch.equal(step['action'], meg['action']))
  pix = float((step['lcd'] == meg['lcd']).float().mean())
  log(f'[reference] mega path vs per-step path on the card, {MAIN_ENV} B={B}'
      f' T={T}: tripwire {ok}, actions equal {act_same}, t=0 frames equal '
      f'{t0_same}, full_state median err {np.median(err_m):.2e}, worlds > '
      f'5e-3: {(err_m > 5e-3).mean():.3f}, equal pixels {pix:.5f}')
  if not (ok and act_same and t0_same) or np.median(err_m) >= 1e-4 \
      or (err_m > 5e-3).mean() >= 0.03:
    raise RuntimeError('the megakernel path disagrees with the per-step path')
  return dict(median_err=float(np.median(err)), equal_pixels=same,
              mega_median_err=float(np.median(err_m)), mega_equal_pixels=pix)


def _zero_launches():
  torch.cuda.synchronize()
  cuda_raster.LAUNCHES = traj_raster.LAUNCHES = mega.LAUNCHES = 0


def _launches():
  return {'mega_rollout': mega.LAUNCHES, 'traj_raster': traj_raster.LAUNCHES,
          'lcd_raster': cuda_raster.LAUNCHES}


def _check_barrels(env, folder, n_barrels, T):
  files = sorted(Path(folder).glob('*.barrel.npz'))
  if len(files) != n_barrels:
    raise RuntimeError(f'{len(files)} barrels written, not {n_barrels}')
  shape = (BARREL_SIZE, T, env.lcd_h, env.lcd_w)
  for f in files:
    with np.load(f) as z:
      lcd, fs, act = z['lcd'], z['full_state'], z['action']
    if lcd.dtype != bool or lcd.shape != shape:
      raise RuntimeError(f'{f.name}: lcd {lcd.dtype} {lcd.shape}')
    if lcd.all() or not lcd.any():
      raise RuntimeError(f'{f.name}: blank frames')
    if fs.shape != (BARREL_SIZE, T, env.obs_size) or not np.isfinite(fs).all():
      raise RuntimeError(f'{f.name}: full_state {fs.shape} not finite')
    if act.shape != (BARREL_SIZE, T, env.act_size) or np.abs(act).max() > 1:
      raise RuntimeError(f'{f.name}: action {act.shape}')
  ds = RolloutDataset(Path(folder), infinite=False)
  n_batches = sum(1 for _ in ds.batches(BARREL_SIZE))
  if n_batches != n_barrels:
    raise RuntimeError(f'RolloutDataset gave {n_batches} batches')
  log(f'[main] {len(files)} barrels load: lcd bool {shape}, background '
      f'share {float(lcd.mean()):.3f}')


def main_path_phase(dev, smi):
  """fill_barrels through the megakernel path, its launches, its barrels,
  the device's busy share, and the per-layer times of one dispatch."""
  env = _env(MAIN_ENV, dev)
  T = int(env.G.ep_len)
  gen = torch.Generator(device=dev).manual_seed(0)
  with tempfile.TemporaryDirectory() as tmp:
    G = AttrDict(logdir=Path(tmp))
    _zero_launches()
    t0 = time.perf_counter()
    fill_barrels(env, MAIN_BARRELS, 'train', G, gen, batch_size=MAIN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    log(f'[main] fill_barrels {MAIN_ENV} {MAIN_BATCH} worlds x {T} steps '
        f'(megakernel path): {wall:.2f} s with barrel writes, '
        f'{MAIN_BATCH * T / wall:.1f} env-steps/s on {smi}; launches '
        f'{launches}')
    if launches != {'mega_rollout': 1, 'traj_raster': 1, 'lcd_raster': 1}:
      raise RuntimeError(f'main path launches {launches}: each kernel must '
                         f'launch once in one dispatch')
    _check_barrels(env, Path(tmp) / 'train', MAIN_BARRELS, T)

  # the device's busy share of a whole call: summed kernel durations over
  # the call's wall time, from a second call under the profiler
  with tempfile.TemporaryDirectory() as tmp:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
      t0 = time.perf_counter()
      fill_barrels(env, MAIN_BARRELS, 'train', AttrDict(logdir=Path(tmp)),
                   gen, batch_size=MAIN_BATCH)
      torch.cuda.synchronize()
      prof_wall = time.perf_counter() - t0
    dev_us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False))
  busy = dev_us / 1e6 / prof_wall
  log(f'[main] busy share of a fill_barrels call: {busy:.4f} (device '
      f'{dev_us / 1e3:.1f} ms of {prof_wall * 1e3:.1f} ms, profiled)')

  # per-layer times of one dispatch (4000 worlds x 100 steps)
  st = Env.reset(env, gen, MAIN_BATCH)
  acts = torch.rand((MAIN_BATCH, T, env.act_size), generator=gen,
                    device=dev) * 2 - 1
  ms = _motor_speeds(env, acts)
  rollout = mega.make_rollout(env.spec, T)
  render = traj_raster.make_traj_render(env.spec, env.lcd_w, env.lcd_h)
  _, traj = rollout.kernel_rollout(st, ms)
  n, B, W, H = env.spec.n, MAIN_BATCH, env.lcd_w, env.lcd_h
  pose0 = torch.cat([st.c.permute(1, 2, 0), st.a.T[:, None]], 1)[None]

  def concat():
    poses = torch.cat([pose0, traj['stream']])[:T]
    return poses, torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])

  poses, cosa, sina = concat()
  rows = render.kernel_rows(poses, cosa, sina, st.is_circle)
  cs = poses[:, :, :2].permute(0, 3, 1, 2).reshape(T * B, n, 2)
  as_ = poses[:, :, 2].permute(0, 2, 1).reshape(T * B, n)
  ic = st.is_circle[None].expand(T, B, n).reshape(T * B, n)
  fn, _ = make_mega_rollout_fn(env, pack_lcd=True)
  out = fn.core(st, acts)

  def to_host():
    return {k: v.cpu().numpy() for k, v in out.items()}

  host = to_host()
  layers = {
      'megakernel': ('device', events_ms(
          lambda: rollout.kernel_rollout(st, ms), 3)),
      'cos_sin_concat': ('host', wall_ms(concat, 5)),
      'traj_raster': ('device', events_ms(
          lambda: render.kernel_rows(poses, cosa, sina, st.is_circle), 20)),
      'observe_pose': ('host', wall_ms(
          lambda: env.observe_pose(ic, cs, as_, lcd=False), 5)),
      'packing': ('host', wall_ms(lambda: pack_bits(raster.unpack_rows(
          rows, W).transpose(0, 1)), 5)),
      'device_to_host': ('host', wall_ms(to_host, 3)),
  }
  with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    for j in range(MAIN_BARRELS):
      sl = slice(j * BARREL_SIZE, (j + 1) * BARREL_SIZE)
      traj_j = {k: v[sl] for k, v in host.items() if k != 'obs_ok'}
      lcd = np.unpackbits(traj_j.pop('lcd'), axis=-1)
      np.savez_compressed(Path(tmp) / f'{j}.barrel', lcd=lcd.astype(bool),
                          **traj_j)
    layers['barrel_writes'] = ('host', (time.perf_counter() - t0) * 1e3)
  layers['dispatch'] = ('host', wall_ms(lambda: fn.core(st, acts), 2))
  for name, (clock, t) in layers.items():
    log(f'[main] layer {name}: {t:.3f} ms a dispatch ({clock} clock, '
        f'{MAIN_BATCH} worlds x {T} steps, {smi})')
  return dict(launches=launches, wall_s=wall,
              env_steps_per_s=MAIN_BATCH * T / wall, busy_share=busy,
              layers={k: t for k, (_, t) in layers.items()})


def per_step_phase(dev, smi):
  """fill_barrels with collect_mega=0 (the per-step path) at a cut depth:
  the per-frame raster launches once a step; then the per-layer times of one
  step at the main path's 4000 worlds."""
  T = PER_STEP_T
  env = _env(MAIN_ENV, dev, ep_len=T)
  gen = torch.Generator(device=dev).manual_seed(0)
  with tempfile.TemporaryDirectory() as tmp:
    _zero_launches()
    t0 = time.perf_counter()
    fill_barrels(env, 1, 'train', AttrDict(logdir=Path(tmp), collect_mega=0),
                 gen, batch_size=PER_STEP_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    log(f'[per-step] fill_barrels {MAIN_ENV} {PER_STEP_BATCH} worlds x {T} '
        f'steps, collect_mega=0: {wall:.2f} s with barrel writes, '
        f'{PER_STEP_BATCH * T / wall:.1f} env-steps/s on {smi}; launches '
        f'{launches}')
    if launches != {'mega_rollout': 0, 'traj_raster': 0, 'lcd_raster': T}:
      raise RuntimeError(f'per-step path launches {launches}')
    _check_barrels(env, Path(tmp) / 'train', 1, T)

  # per-layer times of one step at 4000 worlds: wall time (host clock,
  # dispatch included) and device time (profiler)
  env = _env(MAIN_ENV, dev)
  st = Env.reset(env, gen, MAIN_BATCH)
  act = torch.rand((MAIN_BATCH, env.act_size), generator=gen, device=dev)
  frame = raster.lcd_render(env.spec, st.is_circle, st.c, st.a, env.lcd_w,
                            env.lcd_h)
  layers = {
      'physics': (5, lambda: physics.step_world_batch(env.spec, st, act)),
      'raster': (20, lambda: raster.lcd_render(
          env.spec, st.is_circle, st.c, st.a, env.lcd_w, env.lcd_h)),
      'obs_packing': (20, lambda: (
          env.observe_pose(st.is_circle, st.c, st.a, lcd=False),
          pack_bits(frame))),
  }
  per_layer = {}
  for name, (n, fn) in layers.items():
    w, d = wall_ms(fn, n), profiled_ms(fn, n)
    per_layer[name] = dict(wall_ms=w, device_ms=d)
    log(f'[per-step] layer {name}: {w:.3f} ms a step with dispatch, device '
        f'{_fmt(d)} ({MAIN_BATCH} worlds, {smi})')
  return dict(launches=launches, wall_s=wall,
              env_steps_per_s=PER_STEP_BATCH * T / wall, layers=per_layer)


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--out', default=None, help='also write the results here')
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  dev = torch.device('cuda')
  t_start = time.time()
  smi = card_phase()
  build = build_phase()
  phase_s = {}

  def run(name, fn, *a):
    t0 = time.time()
    out = fn(*a)
    phase_s[name] = time.time() - t0
    log(f'[{name}] phase done in {phase_s[name]:.1f} s')
    return out

  kern = run('kernel', kernel_phase, dev)
  traj = run('traj', traj_phase, dev)
  meg = run('mega', mega_phase, dev)
  ref = run('reference', reference_phase, dev)
  main_run = run('main', main_path_phase, dev, smi)
  step_run = run('per-step', per_step_phase, dev, smi)
  lt, tt, mt = kern['times'][TRIPWIRE_FRAMES], traj['times'], meg['times']
  launches = main_run['launches']
  kernels = [{
      'name': 'mega_rollout', 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/mega_rollout.cu',
      'replaces': 'boxlcd_tpu/engine/mega.py:1673',
      'launches': launches['mega_rollout'], 'max_abs_err': meg['max_abs_err'],
      'ms': mt['ms'], 'plain_ms': mt['plain_ms'], 'bound_ms': mt['bound_ms'],
      'bound_by': mt['bound_by'], 'library_ms': None,
  }, {
      'name': 'traj_raster', 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/traj_raster.cu',
      'replaces': 'boxlcd_tpu/render/traj_raster.py:223',
      'launches': launches['traj_raster'], 'mismatches': traj['mismatches'],
      'max_abs_err': traj['max_abs_err'],
      'ms': tt['ms'], 'plain_ms': tt['plain_ms'], 'bound_ms': tt['bound_ms'],
      'bound_by': tt['bound_by'], 'library_ms': None,
  }, {
      'name': 'lcd_raster', 'route': 'cuda',
      'source': 'boxlcd_tpu_torch/csrc/lcd_raster.cu',
      'replaces': 'boxlcd_tpu/render/pallas_raster.py:131',
      'launches': launches['lcd_raster'], 'mismatches': kern['mismatches'],
      'max_abs_err': kern['max_abs_err'],
      'ms': lt['ms'], 'plain_ms': lt['plain_ms'], 'bound_ms': lt['bound_ms'],
      'bound_by': lt['bound_by'], 'library_ms': None,
  }]
  if args.out:
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(
        card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build, phase_s=phase_s, kernel=kern, traj=traj, mega=meg,
        reference=ref, main=main_run, per_step=step_run, kernels=kernels,
        seconds=time.time() - t_start), indent=1, default=str))
  log(f'[done] {time.time() - t_start:.1f} s')
  log(smi)
  log(json.dumps({'kernels': kernels}))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
