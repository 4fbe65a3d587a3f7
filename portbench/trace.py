"""The device side of a traced window, read from torch.profiler's trace: the
seconds in which an operation ran on the device (the union of the kernels'
and copies' intervals), the operations by name, and the idle gaps between
them."""
from __future__ import annotations

import contextlib

import torch

NAME_CHARS = 96   # kernel names are long template instantiations


def profiler(on, device):
  """A torch.profiler context over the card's activity (kernels, copies;
  no host ops, which would cost the host time in every launch) where `on`
  and the device is a card, else a no-op context (None as its value)."""
  if not on or torch.device(device).type != 'cuda':
    return contextlib.nullcontext()
  from torch.profiler import ProfilerActivity, profile
  return profile(activities=[ProfilerActivity.CUDA])


def device_events(prof):
  """[(name, start us, end us)] of the device's own events (kernels,
  copies, sets), without user annotations, read from the profiler's raw
  results (building its event tree would take minutes over a window)."""
  out = []
  for e in prof.profiler.kineto_results.events():
    if e.device_type() != torch.autograd.DeviceType.CUDA or \
        e.is_user_annotation():
      continue
    s = e.start_ns() / 1e3
    out.append((e.name(), s, s + e.duration_ns() / 1e3))
  return out


def activity(events):
  """(busy seconds: the union of the events' intervals, {name: (seconds,
  count)}, [(start us, end us) of each idle gap between events])."""
  by = {}
  spans = sorted((s, e) for _, s, e in events)
  for name, s, e in events:
    t, c = by.get(name, (0.0, 0))
    by[name] = (t + (e - s) / 1e6, c + 1)
  busy, gaps = 0.0, []
  cur_s = cur_e = None
  for s, e in spans:
    if cur_e is None or s > cur_e:
      if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, s))
      cur_s, cur_e = s, e
    else:
      cur_e = max(cur_e, e)
  if cur_e is not None:
    busy += cur_e - cur_s
  return busy / 1e6, by, gaps


def top_ops(by, n=10):
  """The n device operations that took most time: [[name, seconds]]."""
  ops = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
  return [[f'{k[:NAME_CHARS]} (x{c})', s] for k, (s, c) in ops]
