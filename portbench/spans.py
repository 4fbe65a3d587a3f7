"""One cell's window with the program's own tracer on: what the traced run
would read from the program's spans and counters, and what tracing costs.

    python3 -m portbench.spans --workload <name> --seed <n> --seconds <s>

From the root of a checkout, on a card. After the cell's warm-up it runs
six windows of `--seconds` each with the cell's own generator (WINDOWS):
untraced and with the tracer on (boxlcd_tpu_torch.trace: the spans and the
megakernel's counted instance) in turns, then under torch.profiler alone,
as a `--trace 1` run of portbench.run profiles, and under the profiler
with the tracer on. It prints one JSON line: each window's rate, and from
the last window the readings of portbench/metrics/_spans.py, the device
time, idle time (the breakdown's `program: <span>` entries) and
synchronisations by the innermost span open on the host, and the
counters; then the stage pass's `glue_ms` (portbench/metrics/_read.py)
beside `glue_span_ms`.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

import torch

from portbench import run as prun
from portbench import trace
from portbench.metrics import _read, _spans

# (name, under the profiler, with the tracer on), in the order they run:
# the untraced and tracer windows in turns, then the profiled ones
WINDOWS = (('untraced', False, False), ('tracer', False, True),
           ('tracer', False, True), ('untraced', False, False),
           ('profiler', True, False), ('profiler+tracer', True, True))
READERS = ('glue_span_ms', 'syncs_per_dispatch', 'ngs_iters', 'bvae_span_ms',
           'fbt_span_ms', 'step_host_ms')


def _window(cell, seconds, profile, traced):
  from boxlcd_tpu_torch import trace as tracer
  if traced:
    tracer.start()
  _, _, steps, wall = cell.window(seconds, profile=profile)
  prog = tracer.stop() if traced else None
  return steps / wall, wall, prog


def main(argv=None, device=None, root=None, overrides=None):
  """One run; returns the line (also printed). device='cpu' and
  `overrides` as portbench.run.main takes them (tests only): on the CPU
  the profiler is off, so only the host's readings come out."""
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  args = p.parse_args(argv)
  root = Path(root or os.getcwd())
  prun.cache_env(root)
  _, cfg, traffic, _, _ = prun.load_cell(root, args.workload)
  prun.apply_overrides(cfg, traffic, overrides)
  if device is None:
    if not torch.cuda.is_available():
      print('portbench.spans: needs a CUDA device; no result',
            file=sys.stderr)
      sys.exit(3)
    device = 'cuda:0'
  device = torch.device(device)
  on_card = device.type == 'cuda'
  if on_card:
    prun.card_setup(device)
  generator = importlib.import_module(
      f'portbench.drivers.{traffic["driver"]}')
  cell = generator.Cell(cfg, traffic, args.seed, device)
  t0 = time.perf_counter()
  cell.warm()
  warm_s = time.perf_counter() - t0
  rates = {}
  for name, profile, traced in WINDOWS:
    encoded = len(cell.spans.get('encode_s', []))
    rate, wall, prog = _window(cell, args.seconds, profile, traced)
    rates.setdefault(name, []).append(rate)
  # the generator's own host spans of the last window: the barrel encode
  encode_s = sum(cell.spans.get('encode_s', [])[encoded:])
  rec = {'program': prog, 'events': None if cell.prof is None else
         _spans.profiler_events(cell.prof)}
  busy = rec['events'] and trace.activity(
      [e[:3] for e in rec['events']['device']])[0]
  readings = {k: getattr(_spans, k)(rec) for k in READERS}
  by = _spans.device_by_span(rec) or {}
  idle = _spans.idle_by_span(rec)
  stage = cell.stages()[0] if on_card and hasattr(cell, 'stages') else None
  out = {
      'workload': args.workload, 'seed': args.seed,
      'card': prun.card_line() if on_card else None,
      'device': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'warm_s': warm_s,
      'rates': rates, 'readings': readings,
      'stage_glue_ms': _read.glue_ms({'stages_ms': stage}) if stage else None,
      'stages_ms': stage, 'window_s': wall, 'busy_s': busy,
      'device_ms_by_span': {k or '(no span)': [us / 1e3, n]
                            for k, (us, n) in sorted(by.items())},
      'idle_by_span': idle[0] if idle else None,
      'idle_no_span_s': idle[1] if idle else None,
      'syncs_by_span': _spans.syncs_by_span(rec),
      'encode_s': encode_s,
      'counters': prog['counters'],
      'spans': {k: sum(1 for s in prog['spans'] if s['name'] == k)
                for k in sorted({s['name'] for s in prog['spans']})},
  }
  print(json.dumps(out), flush=True)
  return out


if __name__ == '__main__':
  main()
