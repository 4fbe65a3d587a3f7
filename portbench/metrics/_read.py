"""Readers shared by the per-layer metrics of collection traffic. Each takes
the traced run's record (spans and counters of the window, the stage pass's
CUDA-event times, the yardstick's inputs) and returns the metric, or None
where the record holds nothing to read."""
from __future__ import annotations

from portbench import yardstick


def _stage(rec, name):
  ms = rec.get('stages_ms', {}).get(name)
  return ms if ms else None


def mega_roofline(rec):
  """The megakernel's least time (frozen count) over its time alone, %."""
  ms, y = _stage(rec, 'megakernel'), rec.get('yard')
  if ms is None or y is None:
    return None
  bound = yardstick.mega_bound(y['spec'], y['final'], y['B'], y['T'])[0]
  return 100.0 * bound / ms


def traj_raster_roofline(rec):
  """The trajectory raster's least time over its time alone, %."""
  ms, y = _stage(rec, 'traj_raster'), rec.get('yard')
  if ms is None or y is None:
    return None
  bound = yardstick.traj_bound(y['spec'], y['is_circle'], y['T'],
                               y['lcd_h'], y['raster_tables'])[0]
  return 100.0 * bound / ms


def glue_ms(rec):
  """Device ms of a dispatch less the megakernel and the raster."""
  parts = [_stage(rec, k) for k in ('dispatch', 'megakernel', 'traj_raster')]
  if any(p is None for p in parts):
    return None
  return parts[0] - parts[1] - parts[2]


def host_ms(rec):
  """Host ms a dispatch: the copy to the host and the barrel encode."""
  copy, enc = rec['spans'].get('copy_s'), rec['spans'].get('encode_s')
  if not copy or not enc:
    return None
  return 1e3 * (sum(copy) + sum(enc)) / len(copy)


def idle_pct(rec):
  """100 - the device's busy share of the window (CUDA events)."""
  busy, win = rec.get('busy_s'), rec.get('window_s')
  if not busy or not win:
    return None
  return 100.0 * (1.0 - busy / win)


def mfu(rec):
  """Operations of the window's completed env-steps (the megakernel's
  frozen count and the raster's, per env-step) over the window's time,
  as a share of 67 TFLOP/s float32."""
  y, win, steps = rec.get('yard'), rec.get('window_s'), rec.get('steps')
  if y is None or not win or not steps:
    return None
  B, T = y['B'], y['T']
  per_step = (yardstick.mega_flops(y['spec'], y['final'], B, T)
              + T * yardstick.raster_flops(y['spec'], y['is_circle'],
                                           y['lcd_h'])) / (B * T)
  return 100.0 * per_step * steps / win / yardstick.FP32_FLOPS


def mfu_dream(rec):
  """Model operations of the traced window's dream steps (from shapes) over
  its time, as a share of 989 TFLOP/s (dense bfloat16: the highest rate a
  precision change could use)."""
  y, win, n = rec.get('yard'), rec.get('window_s'), rec.get('dream_steps')
  if y is None or not win or not n:
    return None
  return 100.0 * yardstick.dream_step_flops(y) * n / win / \
      yardstick.BF16_FLOPS


def kernels_per_step(rec):
  """Device kernel events of the traced window over its dream steps."""
  n, k = rec.get('dream_steps'), rec.get('kernel_count')
  if not n or not k:
    return None
  return k / n
