"""Spans and counters of the port, held in memory.

    from boxlcd_tpu_torch import trace
    trace.start()
    ...                      # fill_barrels, a PPO epoch, a dream call
    rec = trace.stop()       # {'spans': [...], 'counters': {...}}

`span(name)` is a context manager around the work of one layer. Each span
records its name, its start and end (`start_us`, `end_us`: microseconds on
torch.profiler's clock, the clock of its device events), its id, its
parent's id (-1 for a root) and its root's id. A root span is one request
of a batch job, one collection dispatch (`collect.dispatch`) or one dream
call (`dream.call`), and every span inside it carries its id as `root`.
Tracing is off by default, and then `span` tests one module flag and hands
back a shared no-op context: it allocates, synchronises and calls nothing.

`count(name, n)` adds to a counter whether tracing is on or not: the CUDA
kernels count their launches under `<kernel>.launches`. `counter(name)`
reads one. Counters only grow (nothing resets them), so a reader diffs two
reads; stop() reports each counter's growth since start().
`world_counts(names, B, device)` hands a kernel, while tracing is on, a
(B, len(names)) int64 buffer on its device, one row a world, to add into;
stop() sums each column into the counter of its name. stop() is the only
read of those buffers, so a counted launch adds no synchronisation.

`spanned(name)` is `span(name)` as a decorator, around a whole function.

The clock: torch.profiler stamps its CUDA events (kernels, copies and the
runtime calls that launched them) in nanoseconds of the wall clock
(`time.time_ns`). Spans read the cheaper monotonic `perf_counter_ns` and
stop() shifts them by the offset between the two, measured at start().
"""
from __future__ import annotations

import functools
import time

import torch

ON = False
_SPANS = []          # [name, start ns, end ns, id, parent id, root id]
_STACK = []          # the open spans' records, innermost last
_COUNTERS = {}
_BASE = {}           # the counters' values at start()
_WORLD = {}          # (names, B, device) -> (B, len(names)) int64 buffer
_OFFSET_NS = 0       # time_ns() - perf_counter_ns(), at start()
_now = time.perf_counter_ns


class _Null:
  """The context `span` returns while tracing is off."""
  __slots__ = ()

  def __enter__(self):
    return None

  def __exit__(self, *exc):
    return False


_NULL = _Null()


class _Span:
  __slots__ = ('rec',)

  def __init__(self, name):
    self.rec = [name, 0, 0]

  def __enter__(self):
    rec = self.rec
    sid = len(_SPANS)
    parent = _STACK[-1] if _STACK else None
    rec += [sid, -1, sid] if parent is None else [sid, parent[3], parent[5]]
    _SPANS.append(rec)
    _STACK.append(rec)
    rec[1] = _now()
    return None

  def __exit__(self, *exc):
    self.rec[2] = _now()
    if _STACK and _STACK[-1] is self.rec:
      _STACK.pop()
    return False


def span(name):
  """A context manager that records `name` around its body while tracing
  is on; a shared no-op context while it is off."""
  if not ON:
    return _NULL
  return _Span(name)


def spanned(name):
  """A decorator: each call of the function runs inside span(name)."""
  def wrap(fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
      if not ON:
        return fn(*args, **kwargs)
      with _Span(name):
        return fn(*args, **kwargs)
    return inner
  return wrap


def count(name, n=1):
  """Add n to the counter `name` (whether tracing is on or not)."""
  _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counter(name):
  """The counter `name`'s value (0 if it never counted)."""
  return _COUNTERS.get(name, 0)


def counters():
  """A copy of every counter."""
  return dict(_COUNTERS)


def world_counts(names, B, device):
  """While tracing is on, a zeroed (B, len(names)) int64 buffer on
  `device` for a kernel to add its per-world counts into, the same buffer
  for every call with these names, B and device until stop(); None while
  tracing is off."""
  if not ON:
    return None
  key = (tuple(names), int(B), str(device))
  buf = _WORLD.get(key)
  if buf is None:
    buf = _WORLD[key] = torch.zeros((int(B), len(names)), dtype=torch.int64,
                                    device=device)
  return buf


def _offset_ns():
  """time_ns() - perf_counter_ns(), from the closest of a few reads."""
  best = None
  for _ in range(5):
    a = _now()
    w = time.time_ns()
    b = _now()
    if best is None or b - a < best[0]:
      best = (b - a, w - (a + b) // 2)
  return best[1]


def start():
  """Turn tracing on, with no spans recorded, the per-world buffers
  dropped and the counters' values kept as the record's zero."""
  global ON, _OFFSET_NS
  _SPANS.clear()
  _STACK.clear()
  _WORLD.clear()
  _BASE.clear()
  _BASE.update(_COUNTERS)
  _OFFSET_NS = _offset_ns()
  ON = True


def stop():
  """Turn tracing off; return {'spans': [...], 'counters': {...}}: the
  closed spans in the order they opened, and each counter that grew since
  start() (or the last stop()) by how much, the per-world buffers summed
  in. The spans and buffers are cleared; the counters keep their values."""
  global ON
  ON = False
  for (names, _, _), buf in _WORLD.items():
    for name, n in zip(names, buf.sum(0).tolist()):
      count(name, int(n))
  off = _OFFSET_NS
  spans = [{'name': r[0], 'start_us': (r[1] + off) / 1e3,
            'end_us': (r[2] + off) / 1e3, 'id': r[3], 'parent': r[4],
            'root': r[5]} for r in _SPANS if r[2]]
  grew = {k: v - _BASE.get(k, 0) for k, v in _COUNTERS.items()
          if v != _BASE.get(k, 0)}
  _SPANS.clear()
  _STACK.clear()
  _WORLD.clear()
  _BASE.clear()
  _BASE.update(_COUNTERS)
  return {'spans': spans, 'counters': grew}
