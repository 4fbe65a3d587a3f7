"""Bench bisection on the card: where does a megakernel-path chunk's time
go? (the port of research/scripts/bench_bisect.py, rethought for the card).

Stages (Urchin, B = 4096, T = 50, 8/4 solver iterations as the port
bench's headline line, unless overridden), each the one before
plus one layer, timed with CUDA events around one call (the best of 3,
after a warm-up):
  phys          the rollout megakernel (csrc/mega_rollout.cu), the final
                state consumed
  phys+tiles    + the (T, N, 3, B) pose stream consumed
  +lcd_kernel   + the trajectory raster (csrc/traj_raster.cu), its row
                bitmasks consumed packed
  +lcd_unpack   + the rows unpacked to bool frames (raster.unpack_rows)
  +full_state   + observe_pose(lcd=False) over the T * B poses: the port
                bench's mega chunk
  full(old)     the megakernel, then observe_pose with the per-frame lcd
                raster (csrc/lcd_raster.cu) over the T * B poses
`+lcd_unpack - +lcd_kernel` is the unpacking glue. The block size of the
megakernel is `--threads` (engine/mega.launch_geometry's choice by
default). Each stage's kernel launches are counted and printed.

    python -m boxlcd_tpu_torch.research.scripts.bench_bisect \
        [--worlds=4096] [--steps=50] [--env=Urchin] [--iters=8,4] \
        [--threads=64] [--device=cpu]

On the card it needs no other process on it; on the CPU (`--device=cpu`)
every stage runs the kernels' plain versions and is timed by the host
clock.
"""
from __future__ import annotations

import argparse
import time

import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import trace, utils
from boxlcd_tpu_torch.engine import mega, physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import raster, traj_raster

STAGES = ('phys', 'phys+tiles', '+lcd_kernel', '+lcd_unpack', '+full_state',
          'full(old)')


def launches():
  return {k: trace.counter(f'{k}.launches')
          for k in ('mega_rollout', 'traj_raster', 'lcd_raster')}


def make_stages(env, T, threads=None):
  """{stage: fn(states, motor_speeds (T, B, J)) -> a tensor consumed}."""
  spec = env.spec
  W, H = env.lcd_w, env.lcd_h
  rollout = mega.make_rollout(spec, T)
  trender = traj_raster.make_traj_render(spec, W, H)

  def roll(s, m):
    if s.c.is_cuda:
      return rollout.kernel_rollout(s, m, threads=threads)
    return rollout(s, m)

  def poses(s, m):
    s2, traj = roll(s, m)
    stream = traj['stream']                                 # (T, n, 3, B)
    return (s2, stream, *mega.flat_poses(stream, s2.is_circle))

  def phys(s, m):
    return roll(s, m)[0].c.sum()

  def tiles(s, m):
    return roll(s, m)[1]['stream'].sum()

  def lcd_kernel(s, m):
    s2, traj = roll(s, m)
    return trender.rows(traj['stream'], s2.is_circle).sum()

  def lcd_unpack(s, m):
    s2, traj = roll(s, m)
    r = trender.rows(traj['stream'], s2.is_circle)
    return raster.unpack_rows(r, W).sum()

  def full_state(s, m):
    s2, stream, ic, cs, as_ = poses(s, m)
    lcd = raster.unpack_rows(trender.rows(stream, s2.is_circle), W)
    obs = env.observe_pose(ic, cs, as_, lcd=False)
    return lcd.sum() + obs['full_state'].sum() + obs['proprio'].sum()

  def full_old(s, m):
    _, _, ic, cs, as_ = poses(s, m)
    obs = env.observe_pose(ic, cs, as_)
    return (obs['lcd'].sum() + obs['full_state'].sum()
            + obs['proprio'].sum())

  return dict(zip(STAGES, (phys, tiles, lcd_kernel, lcd_unpack, full_state,
                           full_old)))


REPEATS = 3                 # timed calls a stage; the best is kept


def time_ms(fn, args, device):
  """The best of REPEATS calls' ms after a warm-up: CUDA events around one
  call on the card, the host clock on the CPU."""
  out = fn(*args)
  if not torch.isfinite(out):
    raise RuntimeError('bench_bisect: non-finite output')
  best = float('inf')
  for _ in range(REPEATS):
    if device.type == 'cuda':
      torch.cuda.synchronize(device)
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn(*args)
      end.record()
      torch.cuda.synchronize(device)
      best = min(best, start.elapsed_time(end))
    else:
      t0 = time.perf_counter()
      fn(*args)
      best = min(best, (time.perf_counter() - t0) * 1e3)
  return best


def run(env_name='Urchin', B=4096, T=50, threads=None, device=None,
        solver_iters=(8, 4)):
  """Time every stage; returns {stage: {'ms', 'msteps_per_s',
  'launches'}} and prints one line a stage."""
  device = utils.resolve_device(device)
  env = boxlcd_tpu_torch.env_map[env_name](
      {'vel_iters': solver_iters[0], 'pos_iters': solver_iters[1]},
      device=device)
  spec = env.spec
  geo = mega.launch_geometry(spec, B, threads) if device.type == 'cuda' \
      else None
  print(f'env={env_name} B={B} T={T} solver iters {spec.vel_iters}/'
        f'{spec.pos_iters} device={device}'
        + (f' megakernel block {geo.threads} threads ({geo.worlds} worlds)'
           if geo else ''), flush=True)
  gen = torch.Generator(device=device).manual_seed(0)
  states = Env.reset(env, gen, B)
  acts = torch.rand((T, B, env.act_size), generator=gen, device=device) * 2 - 1
  ms = physics.motor_speeds(spec, acts).contiguous()
  out = {}
  for name, fn in make_stages(env, T, threads).items():
    before = launches()
    sec = time_ms(fn, (states, ms), device) / 1e3
    count = {k: v - before[k] for k, v in launches().items()}
    out[name] = {'ms': sec * 1e3, 'msteps_per_s': B * T / sec / 1e6,
                 'launches': count}
    print(f'{name:>14}: {B * T / sec / 1e6:10.4f} M steps/s  '
          f'({sec * 1e3:9.3f} ms)  launches {count}', flush=True)
  glue = out['+lcd_unpack']['ms'] - out['+lcd_kernel']['ms']
  print(f'unpack glue (+lcd_unpack - +lcd_kernel): {glue:.3f} ms',
        flush=True)
  return out


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('--worlds', type=int, default=4096)
  p.add_argument('--steps', type=int, default=50)
  p.add_argument('--env', default='Urchin')
  p.add_argument('--threads', type=int, default=None,
                 help='megakernel block size (mega.launch_geometry)')
  p.add_argument('--iters', default='8,4',
                 help='velocity,position solver iterations')
  p.add_argument('--device', default=None)
  args = p.parse_args(argv)
  return run(args.env, args.worlds, args.steps, args.threads, args.device,
             tuple(int(x) for x in args.iters.split(',')))


if __name__ == '__main__':
  main()
