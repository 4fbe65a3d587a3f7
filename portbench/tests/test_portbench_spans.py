"""The readers of the program's spans and counters
(portbench/metrics/_spans.py) on synthetic records, the traced-window tool
(`python3 -m portbench.spans`) at a tiny size, and the dream cell's window
under the program's tracer, on the CPU; on the card (`cuda`), the
profiler's events as the readers take them, on one clock with a span."""
from pathlib import Path

import pytest
import torch

from boxlcd_tpu_torch import trace
from portbench import run as prun
from portbench import spans as pspans
from portbench.metrics import _spans
from portbench.tests.test_portbench_run import DREAM_CONFIG, TINY

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def tracing_off():
  """Each test starts and ends with tracing off and nothing recorded."""
  trace.stop()
  yield
  trace.stop()


# the dream cell at test_portbench_run.py's tiny widths
DREAM = {'config': DREAM_CONFIG, 'traffic': TINY['dream.urchin-fbt']}


def test_dream_cell_window_spans():
  """The dream cell's window, traced: each call of the cell's generator is
  one dream.call with its steps, and the pools it draws itself a root."""
  from portbench.drivers.dream import Cell
  _, cfg, traffic, _, _ = prun.load_cell(ROOT, 'dream.urchin-fbt')
  prun.apply_overrides(cfg, traffic, DREAM)
  cell = Cell(cfg, traffic, 5, 'cpu')
  cell.warm()
  trace.start()
  cell.window(0.0)                     # one call of 8 steps
  rec = trace.stop()
  spans = rec['spans']
  by = {s['id']: s for s in spans}
  call, = [s for s in spans if s['name'] == 'dream.call']
  kids = [s['name'] for s in spans if s['parent'] == call['id']]
  assert kids == ['dream.step'] * 8 + ['dream.host_copy']
  for s in spans:
    if s['name'].startswith('onestep.') or s['name'] in ('dream.policy',
                                                         'dream.env'):
      assert by[s['parent']]['name'] == 'dream.step'
      assert s['root'] == call['id']
  step = [s for s in spans if s['parent'] == call['id']][0]['id']
  assert [s['name'] for s in spans if s['parent'] == step] == [
      'dream.policy', 'onestep.encode', 'onestep.fbt', 'onestep.draw',
      'onestep.decode', 'dream.env']
  # the cell's generator draws the pools itself, a root of their own
  assert [s['parent'] for s in spans if s['name'] == 'dream.pools'] == [-1]


def _sp(name, sid, parent, root, a, b):
  return {'name': name, 'id': sid, 'parent': parent, 'root': root,
          'start_us': float(a), 'end_us': float(b)}


# a synthetic traced window: two collection dispatches and two dream steps
# on one host timeline, the device events launched from inside them, and
# the runtime calls that launched them (times in us)
SPANS = [
    _sp('collect.dispatch', 0, -1, 0, 0, 100),
    _sp('collect.reset', 1, 0, 0, 0, 10),
    _sp('collect.megakernel', 2, 0, 0, 10, 20),
    _sp('collect.glue', 3, 0, 0, 20, 40),
    _sp('collect.tripwire', 4, 0, 0, 40, 90),
    _sp('collect.dispatch', 5, -1, 5, 200, 300),
    _sp('collect.glue', 6, 5, 5, 200, 220),
    _sp('collect.megakernel', 7, 5, 5, 220, 230),
    _sp('dream.step', 8, -1, 8, 400, 440),
    _sp('onestep.encode', 9, 8, 8, 400, 410),
    _sp('onestep.fbt', 10, 8, 8, 410, 420),
    _sp('onestep.draw', 11, 8, 8, 420, 425),
    _sp('onestep.decode', 12, 8, 8, 425, 430),
    _sp('dream.step', 13, -1, 13, 440, 500),
    _sp('onestep.encode', 14, 13, 13, 445, 450),
]
RUNTIME = [                 # (name, start, end, correlation)
    ('cudaLaunchKernel', 2, 3, 1),          # reset
    ('cudaLaunchKernel', 12, 13, 2),        # megakernel
    ('cudaLaunchKernel', 25, 26, 3),        # glue
    ('cudaMemcpyAsync', 41, 42, 4),         # the tripwire's copy
    ('cudaStreamSynchronize', 42, 80, 5),   # ... which blocks the host
    ('cudaLaunchKernel', 85, 86, 6),        # tripwire
    ('cudaLaunchKernel', 205, 206, 7),      # glue
    ('cudaLaunchKernel', 222, 223, 8),      # megakernel
    ('cudaDeviceSynchronize', 350, 360, 9),  # the generator's, outside
    ('cudaLaunchKernel', 402, 403, 10),     # encode
    ('cudaLaunchKernel', 412, 413, 11),     # fbt
    ('cudaLaunchKernel', 421, 422, 12),     # draw
    ('cudaLaunchKernel', 426, 427, 13),     # decode
    ('cudaLaunchKernel', 446, 447, 14),     # encode
    ('cudaLaunchKernel', 600, 601, 15),     # outside every span
]
DEVICE = [                  # (name, start, end, correlation)
    ('reset_k', 5, 9, 1), ('mega_k', 14, 60, 2), ('glue_k', 60, 70, 3),
    ('HtoD', 70, 71, 4), ('trip_k', 95, 97, 6), ('glue_k', 207, 215, 7),
    ('mega_k', 225, 265, 8), ('enc_k', 404, 412, 10), ('fbt_k', 414, 420, 11),
    ('draw_k', 422, 423, 12), ('dec_k', 428, 432, 13), ('enc_k', 448, 455, 14),
    ('stray_k', 602, 610, 15)]


def _record():
  return {'program': {'spans': [dict(s) for s in SPANS],
                      'counters': {'mega_rollout.ngs_iters': 1800,
                                   'mega_rollout.world_substeps': 600}},
          'events': {'device': list(DEVICE), 'runtime': list(RUNTIME)}}


def test_innermost_timeline():
  tl = _spans.Timeline(SPANS)
  assert tl.at(5)['name'] == 'collect.reset'
  assert tl.at(95)['name'] == 'collect.dispatch'   # after the tripwire
  assert tl.at(150) is None
  assert tl.at(442)['name'] == 'dream.step'
  part, none = tl.overlap(85, 210)
  assert part == {'collect.tripwire': 5.0, 'collect.dispatch': 10.0,
                  'collect.glue': 10.0}
  assert none == 100.0


def test_device_operations_and_idle_by_span():
  rec = _record()
  by = _spans.device_by_span(rec)
  assert by['collect.megakernel'] == (86.0, 2)
  assert by['collect.glue'] == (18.0, 2)
  assert by['collect.tripwire'] == (3.0, 2)    # the copy and the kernel
  assert by[''] == (8.0, 1)                     # launched outside any span
  rows, rest = _spans.idle_by_span(rec)
  idle = dict(rows)
  # the gaps (us): 9-14, 71-95, 97-207, 215-225, 265-404, 412-414,
  # 420-422, 423-428, 432-448, 455-602
  assert idle == pytest.approx({
      'program: collect.reset': 1e-6, 'program: collect.megakernel': 9e-6,
      'program: collect.tripwire': 19e-6, 'program: collect.dispatch': 43e-6,
      'program: collect.glue': 12e-6, 'program: onestep.encode': 7e-6,
      'program: onestep.fbt': 2e-6, 'program: onestep.draw': 4e-6,
      'program: onestep.decode': 3e-6, 'program: dream.step': 58e-6})
  assert [r[0] for r in rows][:2] == ['program: dream.step',
                                      'program: collect.dispatch']
  assert rest == pytest.approx(302e-6)
  assert _spans.syncs_by_span(rec) == {'collect.tripwire': 1, '': 1}


@pytest.mark.parametrize('reader,want', [
    ('glue_span_ms', (4 + 10 + 1 + 2 + 8) / 1e3 / 2),
    ('syncs_per_dispatch', 0.5),
    ('ngs_iters', 3.0),
    ('bvae_span_ms', (8 + 4 + 7) / 1e3 / 2),
    ('fbt_span_ms', (6 + 1) / 1e3 / 2),
    ('step_host_ms', (40 + 60) / 1e3 / 2),
])
def test_span_metric_readers(reader, want):
  fn = getattr(_spans, reader)
  assert fn(_record()) == pytest.approx(want)
  # a program without the spans and counters (the parent), and a run
  # without the profiler: nothing to read, no error
  assert fn({'program': {'spans': [], 'counters': {}},
             'events': {'device': [], 'runtime': []}}) is None
  assert fn({}) is None


def test_span_tool_runs_a_tiny_cell():
  """portbench.spans end to end on the CPU at the tiny dream size: the
  four windows' rates and the host's readings (no profiler there)."""
  line = pspans.main(['--workload', 'dream.urchin-fbt', '--seed', '9',
                      '--seconds', '0.0'], device='cpu', root=ROOT,
                     overrides=DREAM)
  assert set(line['rates']) == {'untraced', 'tracer', 'profiler',
                                'profiler+tracer'}
  assert line['readings']['step_host_ms'] > 0
  assert line['readings']['bvae_span_ms'] is None     # no device events
  assert line['spans']['dream.step'] == 8


@pytest.mark.cuda
def test_profiler_events_on_the_span_clock(cuda_device):
  """profiler_events reads the sleep kernel and the runtime call that
  launched it, joined by correlation id, inside the span around them."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda._sleep(1000)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    trace.start()
    with trace.span('sleep'):
      torch.cuda._sleep(20_000_000)
      torch.cuda.synchronize()
    rec = trace.stop()
  sp, = rec['spans']
  ev = _spans.profiler_events(prof)
  kern = [e for e in ev['device'] if 'spin_kernel' in e[0]]
  assert len(kern) == 1
  _, ks, ke, corr = kern[0]
  launch = [e for e in ev['runtime'] if e[3] == corr]
  assert len(launch) == 1
  assert sp['start_us'] <= launch[0][1] <= ks < ke <= sp['end_us']
  assert ke - ks > 1000          # the sleep, not a stray event
