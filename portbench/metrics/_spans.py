"""Readers of the program's own spans and counters (boxlcd_tpu_torch.trace)
in a traced window, beside torch.profiler's events of the same window.

The record they read holds:
  program  the tracer's stop(): {'spans': [{'name', 'start_us', 'end_us',
           'id', 'parent', 'root'}], 'counters': {name: n}}
  events   profiler_events(prof): {'device': [(name, start us, end us,
           correlation id)], 'runtime': [(name, start us, end us,
           correlation id)]}, the device's kernels and copies and the host's
           CUDA runtime calls, on one clock with the spans
Each reader returns None where the record holds nothing to read (a program
without the spans, a run without the profiler).

A device operation belongs to the innermost span open on the host when the
runtime call that launched it ran (the profiler's correlation id joins the
two); an idle gap of the device, to the innermost span open on the host
during each part of it.
"""
from __future__ import annotations

import bisect

import torch

# the runtime calls that block the host until the device has caught up
SYNC_CALLS = ('cudaDeviceSynchronize', 'cudaStreamSynchronize',
              'cudaEventSynchronize')
GLUE_SPANS = ('collect.reset', 'collect.actions', 'collect.glue',
              'collect.tripwire')
BVAE_SPANS = ('onestep.encode', 'onestep.decode')
FBT_SPANS = ('onestep.fbt', 'onestep.draw')


def profiler_events(prof):
  """{'device': [...], 'runtime': [...]} of a torch.profiler run over CUDA
  activity: the device's own events (no user annotations) and the host's
  CUDA runtime calls, each (name, start us, end us, correlation id)."""
  dev, rt = [], []
  cuda = torch.autograd.DeviceType.CUDA
  for e in prof.profiler.kineto_results.events():
    if e.is_user_annotation():
      continue
    s = e.start_ns() / 1e3
    row = (e.name(), s, s + e.duration_ns() / 1e3, e.correlation_id())
    if e.device_type() == cuda:
      dev.append(row)
    elif row[0].startswith('cuda'):
      rt.append(row)
  return {'device': dev, 'runtime': rt}


def innermost(spans):
  """The host timeline as [(start us, end us, span)] pieces, each with the
  innermost span open over it; spans nest (one host thread)."""
  out, stack = [], []
  cur = None            # start of the piece the stack's top owns
  for sp in sorted(spans, key=lambda s: (s['start_us'], -s['end_us'])):
    while stack and stack[-1]['end_us'] <= sp['start_us']:
      top = stack.pop()
      out.append((cur, top['end_us'], top))
      cur = top['end_us']
    if stack:
      out.append((cur, sp['start_us'], stack[-1]))
    stack.append(sp)
    cur = sp['start_us']
  while stack:
    top = stack.pop()
    out.append((cur, top['end_us'], top))
    cur = top['end_us']
  return [p for p in out if p[1] > p[0]]


class Timeline:
  """innermost(spans) with a lookup by host time."""

  def __init__(self, spans):
    self.pieces = innermost(spans)
    self.starts = [p[0] for p in self.pieces]

  def at(self, t):
    """The innermost span open at host time t, or None."""
    i = bisect.bisect_right(self.starts, t) - 1
    if i >= 0 and t < self.pieces[i][1]:
      return self.pieces[i][2]
    return None

  def overlap(self, a, b):
    """{span name: us} of the interval [a, b) by innermost span, and the
    us no span covers."""
    out, covered = {}, 0.0
    i = max(0, bisect.bisect_right(self.starts, a) - 1)
    while i < len(self.pieces) and self.pieces[i][0] < b:
      s, e, sp = self.pieces[i]
      d = min(e, b) - max(s, a)
      if d > 0:
        out[sp['name']] = out.get(sp['name'], 0.0) + d
        covered += d
      i += 1
    return out, (b - a) - covered


def device_by_span(rec):
  """{span name: (device us, operations)} of the device operations by the
  innermost span their launch ran in ('' where none), memoised in rec."""
  if '_device_by_span' in rec:
    return rec['_device_by_span']
  prog, ev = rec.get('program'), rec.get('events')
  out = None
  if prog and prog.get('spans') and ev and ev.get('device'):
    tl = Timeline(prog['spans'])
    launch = {c: s for _, s, _, c in ev['runtime']}
    out = {}
    for _, s, e, c in ev['device']:
      t = launch.get(c)
      sp = tl.at(t) if t is not None else None
      k = sp['name'] if sp else ''
      us, n = out.get(k, (0.0, 0))
      out[k] = (us + (e - s), n + 1)
  rec['_device_by_span'] = out
  return out


def idle_gaps(device):
  """[(start us, end us)] of the gaps between the device's operations."""
  spans = sorted((s, e) for _, s, e, _ in device)
  gaps, cur = [], None
  for s, e in spans:
    if cur is not None and s > cur:
      gaps.append((cur, s))
    cur = e if cur is None else max(cur, e)
  return gaps


def idle_by_span(rec):
  """([['program: <span>', seconds]] of the device's idle time by the
  innermost span open on the host, most first; the idle seconds no span
  covers), or None."""
  prog, ev = rec.get('program'), rec.get('events')
  if not (prog and prog.get('spans') and ev and ev.get('device')):
    return None
  tl = Timeline(prog['spans'])
  by, rest = {}, 0.0
  for a, b in idle_gaps(ev['device']):
    part, none = tl.overlap(a, b)
    for k, us in part.items():
      by[k] = by.get(k, 0.0) + us
    rest += none
  rows = sorted(([f'program: {k}', us / 1e6] for k, us in by.items()),
                key=lambda r: -r[1])
  return rows, rest / 1e6


def _spans(rec, name):
  prog = rec.get('program')
  return [s for s in (prog or {}).get('spans', ()) if s['name'] == name]


def _device_ms_per(rec, names, per):
  by, n = device_by_span(rec), len(_spans(rec, per))
  if not by or not n:
    return None
  return sum(by.get(k, (0.0, 0))[0] for k in names) / 1e3 / n


def glue_span_ms(rec):
  """Device ms a dispatch of the operations launched inside the glue's
  spans (collect.reset, .actions, .glue, .tripwire)."""
  return _device_ms_per(rec, GLUE_SPANS, 'collect.dispatch')


def syncs_by_span(rec):
  """{span name: host-blocking synchronisations (SYNC_CALLS) made while it
  was the innermost span open ('' where none)}, or None."""
  prog, ev = rec.get('program'), rec.get('events')
  if not (prog and prog.get('spans') and ev):
    return None
  tl, out = Timeline(prog['spans']), {}
  for name, s, _, _ in ev['runtime']:
    if name in SYNC_CALLS:
      sp = tl.at(s)
      k = sp['name'] if sp else ''
      out[k] = out.get(k, 0) + 1
  return out


def syncs_per_dispatch(rec):
  """Host-blocking synchronisations (SYNC_CALLS) made inside
  collect.dispatch spans, a dispatch."""
  roots, ev = _spans(rec, 'collect.dispatch'), rec.get('events')
  if not roots or not ev:
    return None
  tl = Timeline(roots)
  n = sum(1 for name, s, _, _ in ev['runtime']
          if name in SYNC_CALLS and tl.at(s) is not None)
  return n / len(roots)


def ngs_iters(rec):
  """The megakernel's NGS iterations a world-substep (its counters)."""
  c = (rec.get('program') or {}).get('counters', {})
  it = c.get('mega_rollout.ngs_iters')
  sub = c.get('mega_rollout.world_substeps')
  if not it or not sub:
    return None
  return it / sub


def bvae_span_ms(rec):
  """Device ms a dream step of the operations inside onestep.encode and
  onestep.decode."""
  return _device_ms_per(rec, BVAE_SPANS, 'dream.step')


def fbt_span_ms(rec):
  """Device ms a dream step of the operations inside onestep.fbt and
  onestep.draw."""
  return _device_ms_per(rec, FBT_SPANS, 'dream.step')


def step_host_ms(rec):
  """Host ms a dream.step span: the time the host takes to enqueue a
  step."""
  steps = _spans(rec, 'dream.step')
  if not steps:
    return None
  return sum(s['end_us'] - s['start_us'] for s in steps) / 1e3 / len(steps)
