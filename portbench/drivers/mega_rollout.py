"""The generator for collection traffic: random-policy episodes through the
port's collection entry, `data.collect.make_mega_rollout_fn`'s
`batch_rollout(gen, worlds)` (reset -> rollout megakernel -> trajectory
raster -> unpacking glue and `observe_pose` -> render tripwire), dispatch
after dispatch, from one generator seeded by `--seed`.

A traffic file of this kind says:
  env_config   solver settings laid over the configuration's env settings
               (vel_iters, pos_iters, solver_exit_tol)
  worlds       episodes a dispatch (one per world, ep_len steps each)
  pack_lcd     frames bit-packed on the card (the barrel path) or not
  pipeline     dispatches queued before each synchronise
  host         null: the outputs stay on the card; else
               {"barrel_size": n}: each dispatch is copied to the host and
               encoded as native barrels of n episodes (data/native's codec
               and np.savez, as write_barrel_file(..., 'native') writes
               them), into memory buffers that are then dropped
  check        {"worlds": sampled worlds, "steps": steps the plain
               reference replays}: what the correctness check reads
"""
from __future__ import annotations

import io
import math
import statistics
import time

import numpy as np
import torch

from portbench import trace


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def encode_barrels(traj, lcd_w, barrel_size, codec):
  """Native barrels of one dispatch's host arrays, as write_barrel_file's
  native branch builds them, into memory buffers: a list of BytesIO."""
  B = traj['action'].shape[0]
  out = []
  for j in range(B // barrel_size):
    part = {k: v[j * barrel_size:(j + 1) * barrel_size]
            for k, v in traj.items()}
    action = part.pop('action')
    lcd = part.pop('lcd')
    blob = codec.pack_frames_packed(lcd, (*lcd.shape[:-1], lcd_w))
    buf = io.BytesIO()
    np.savez(buf, action=action, lcd_packed=blob['data'],
             lcd_shape=blob['shape'], **part)
    out.append(buf)
  return out


class Cell:
  """One cell of collection traffic on one device."""

  def __init__(self, cfg, traffic, seed, device):
    import importlib

    import boxlcd_tpu_torch
    from boxlcd_tpu_torch.data import native
    # the module: the package's `collect` name is the entry function
    collect = importlib.import_module('boxlcd_tpu_torch.data.collect')
    self.cfg, self.traffic = cfg, traffic
    self.device = torch.device(device)
    G = dict(cfg['env_config'], **traffic.get('env_config', {}))
    self.env = boxlcd_tpu_torch.env_map[cfg['env']](G, device=self.device)
    self.fn, self.T = collect.make_mega_rollout_fn(
        self.env, pack_lcd=bool(traffic['pack_lcd']))
    self.codec = native
    self.B = int(traffic['worlds'])
    self.K = int(traffic.get('pipeline', 1))
    self.host = traffic.get('host')
    self.gen = torch.Generator(device=self.device)
    self.gen.manual_seed(int(seed))
    self.spans = {'dispatch_s': [], 'copy_s': [], 'encode_s': []}
    self.last = self.prof = None

  # -- one group of dispatches ----------------------------------------------
  def _group(self, timed):
    """K dispatches queued, one synchronise; on the host path each is
    copied and encoded. Returns (episodes, failed episodes)."""
    outs, states = [], []
    for _ in range(self.K):
      states.append(self.gen.get_state())
      out = self.fn(self.gen, self.B)
      if self.host is None:
        outs.append(out)
        continue
      t0 = time.perf_counter()
      traj = {k: v.cpu().numpy() for k, v in out.items()}
      t1 = time.perf_counter()
      ok = bool(traj.pop('obs_ok'))
      bufs = encode_barrels(traj, self.env.lcd_w, int(self.host['barrel_size']),
                            self.codec) if ok else []
      t2 = time.perf_counter()
      if timed:
        self.spans['copy_s'].append(t1 - t0)
        self.spans['encode_s'].append(t2 - t1)
      outs.append({'ok': ok, 'traj': traj, 'barrels': bufs})
    if self.host is None:
      ok = torch.stack([o['obs_ok'] for o in outs])
      _sync(self.device)
      oks = [bool(x) for x in ok.cpu()]
    else:
      oks = [o['ok'] for o in outs]
    self.last = (states[-1], outs[-1])
    failed = sum(self.B for ok in oks if not ok)
    return self.K * self.B, failed

  def warm(self):
    """One group: builds or loads every kernel and the codec, at this
    cell's shapes."""
    self._group(timed=False)
    _sync(self.device)

  def window(self, seconds, profile=False):
    """Groups back to back until `seconds` have passed; the window closes
    at the end of the group that crosses it. With `profile` the window runs
    under torch.profiler (the traced run). Returns (episodes, failed,
    env-steps completed, window seconds)."""
    episodes = failed = groups = 0
    _sync(self.device)
    with trace.profiler(profile, self.device) as prof:
      t0 = time.perf_counter()
      while True:
        g0 = time.perf_counter()
        n, f = self._group(timed=True)
        self.spans['dispatch_s'].append((time.perf_counter() - g0) / self.K)
        episodes += n
        failed += f
        groups += 1
        if time.perf_counter() - t0 >= seconds:
          break
      _sync(self.device)
      wall = time.perf_counter() - t0
    self.prof = prof
    steps = (episodes - failed) * self.T
    self.dispatches = groups * self.K
    return episodes, failed, steps, wall

  def readings(self):
    """The window's host-clock spans a dispatch, as quartiles (seconds)."""
    out = {}
    for k, v in self.spans.items():
      if len(v) >= 2:
        q = statistics.quantiles(v, n=4)
        out.update({f'{k}_p25': q[0], f'{k}_p50': q[1], f'{k}_p75': q[2]})
    return out

  # -- what the correctness check reads ---------------------------------------
  def answers(self, seed):
    """The last dispatch of the window, as delivered: the generator state
    it drew from, and for the worlds the check samples from the seed the
    arrays it compares, on the CPU; on the host path the dispatch's host
    arrays and its barrels, which the reference reads back."""
    from portbench.checks.mega_rollout import sample
    idx = sample(seed, self.B, int(self.traffic['check']['worlds']))
    state, out = self.last
    steps = int(self.traffic['check']['steps'])
    if self.host is None:
      sel = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
      pick = {k: out[k][sel].cpu() for k in ('action', 'full_state',
                                             'proprio', 'lcd')}
      lcd = pick['lcd']
      return {'gen_state': state, 'ok': bool(out['obs_ok']),
              'action': pick['action'].numpy(),
              'full_state': pick['full_state'][:, :steps].numpy(),
              'proprio': pick['proprio'][:, :steps].numpy(),
              'lcd': lcd[:, :steps].numpy().astype(bool)}
    return {'gen_state': state, 'ok': out['ok'], 'traj': out['traj'],
            'barrels': [b.getvalue() for b in out['barrels']],
            'barrel_size': int(self.host['barrel_size']),
            'lcd_w': self.env.lcd_w}

  # -- the traced run ---------------------------------------------------------
  def traced(self):
    """What the per-layer readers read, after the window: the device's busy
    seconds and operations in the window (the profiler's trace), the stage
    pass's device ms, and the yardstick's inputs (with the reference's
    compiled world as the spec)."""
    from portbench.checks.mega_rollout import world
    stages, yard = self.stages()
    out = {'stages_ms': stages, 'dispatches': self.dispatches,
           'yard': dict(yard, spec=world(self.cfg, self.traffic).spec)}
    if self.prof is not None:
      busy, by, _ = trace.activity(trace.device_events(self.prof))
      out.update(busy_s=busy, kernels=by,
                 kernel_count=sum(c for _, c in by.values()))
    return out

  def breakdown(self, rec):
    """The traced window's device operations that took most time (the
    profiler's trace) and its device-idle time by what the host was doing
    (the barrel encode's spans, the rest), in seconds over the window."""
    gaps = []
    idle = rec['window_s'] - rec['busy_s']
    enc = sum(rec['spans'].get('encode_s', []))
    if enc:
      gaps.append(['host: native barrel encode (data/native + np.savez)',
                   enc])
    gaps.append(['host: launches, syncs, copies and the rest', idle - enc])
    return {'device_ops': trace.top_ops(rec['kernels']),
            'idle_gaps': sorted(gaps, key=lambda x: -x[1])}

  def stages(self):
    """Device ms of one dispatch's stages on fresh inputs drawn as a
    dispatch draws them, by CUDA events: the whole dispatch, the rollout
    megakernel alone, the trajectory raster alone (each called on its own
    through the port's function for that stage), and Env.reset; with the
    megakernel's final states and inputs for the yardstick."""
    from boxlcd_tpu_torch.engine import mega, physics
    from boxlcd_tpu_torch.envs.env import Env
    from boxlcd_tpu_torch.render import traj_raster
    env, B, T = self.env, self.B, self.T
    spec = env.spec
    gen = self.gen
    states = Env.reset(env, gen, B)
    u = torch.rand((B, T, env.act_size), generator=gen, device=self.device)
    ms = physics.motor_speeds(spec, torch.clamp(u * 2 - 1, min=-1.0))
    ms = ms.transpose(0, 1).contiguous()
    rollout = mega.make_rollout(spec, T)
    final, traj = rollout(states, ms)
    pose0 = torch.cat([states.c.permute(1, 2, 0), states.a.T[:, None]],
                      1)[None]
    poses = torch.cat([pose0, traj['stream']])[:T].contiguous()
    trender = traj_raster.make_traj_render(spec, env.lcd_w, env.lcd_h)
    calls = {
        'dispatch': lambda: self.fn(gen, B),
        'megakernel': lambda: rollout(states, ms),
        'traj_raster': lambda: trender.rows(poses, states.is_circle),
        'reset': lambda: Env.reset(env, gen, B),
    }
    out = {k: events_ms(f, self.device) for k, f in calls.items()}
    return out, {'spec': spec, 'final': final, 'is_circle': states.is_circle,
                 'B': B, 'T': T, 'lcd_h': env.lcd_h,
                 'raster_tables': trender.consts.tables(self.device)}


def events_ms(fn, device, budget_s=0.3):
  """Device ms of one call of fn by CUDA events: a first call, then enough
  repeats to span about `budget_s` (3 to 50), the mean."""
  if device.type != 'cuda':
    return None
  fn()
  torch.cuda.synchronize(device)
  a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
      enable_timing=True)
  a.record()
  fn()
  b.record()
  torch.cuda.synchronize(device)
  first = a.elapsed_time(b)
  n = int(min(50, max(3, math.ceil(budget_s * 1e3 / max(first, 1e-3)))))
  a.record()
  for _ in range(n):
    fn()
  b.record()
  torch.cuda.synchronize(device)
  return a.elapsed_time(b) / n
