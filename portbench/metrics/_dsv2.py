"""Readers of the per-layer metrics of dream traffic over the DeepSeek-V2
world model (`portbench/drivers/dream_dsv2.py`). Each takes the traced
run's record and returns the metric, or None where the record holds
nothing to read (a program without the model, its spans or its
counters)."""
from __future__ import annotations

from portbench import yardstick_dsv2
from portbench.metrics import _spans

# the grouped-expert GEMM kernels (the program's csrc/moe_experts.cu), as
# the profiler's names of them contain them
EXPERT_KERNELS = ('moe_gate_up_kernel', 'moe_down_kernel')


def profiler_events(prof):
  """`_spans.profiler_events`, with the CUDA driver's launch calls
  (`cuLaunchKernel*`, by which Triton launches) among the host's calls, so
  that the grouped-expert kernel's launches find their span."""
  ev = _spans.profiler_events(prof)
  import torch
  cuda = torch.autograd.DeviceType.CUDA
  for e in prof.profiler.kineto_results.events():
    if e.device_type() != cuda and e.name().startswith('cuLaunch'):
      s = e.start_ns() / 1e3
      ev['runtime'].append((e.name(), s, s + e.duration_ns() / 1e3,
                            e.correlation_id()))
  return ev


def mfu(rec):
  """Model operations of the traced window's dream steps (from shapes,
  `yardstick_dsv2.dsv2_step_flops`) over its time, as a share of 989
  TFLOP/s (dense bfloat16)."""
  y, win, n = rec.get('yard'), rec.get('window_s'), rec.get('dream_steps')
  if y is None or 'cfg' not in y or not win or not n:
    return None
  return 100.0 * yardstick_dsv2.dsv2_step_flops(y) * n / win / \
      yardstick_dsv2.BF16_FLOPS


def expert_kernel_s(rec):
  """Device seconds of the grouped-expert GEMM kernels in the window."""
  by = rec.get('kernels') or {}
  s = sum(t for name, (t, _) in by.items()
          if any(k in name for k in EXPERT_KERNELS))
  return s or None


def moe_roofline(rec):
  """The routed experts' least time (`moe_expert_bound` at the slots the
  counters saw, each MoE layer of each dream step) over the two GEMM
  kernels' device time in the window (the timed path), %."""
  y, n = rec.get('yard'), rec.get('dream_steps')
  c = (rec.get('program') or {}).get('counters', {})
  slots, t = c.get('moe.tokens_routed'), expert_kernel_s(rec)
  if y is None or 'cfg' not in y or not n or not slots or not t:
    return None
  calls = n * yardstick_dsv2.moe_layers(y['cfg'])
  bound = calls * yardstick_dsv2.moe_expert_bound(y['cfg'], slots / calls)
  return 100.0 * bound / t


def _span_ms(rec, name):
  """Device ms a call of the transformer's module of the operations
  launched inside `name` spans, from the traced run's eager calls (the
  timed path replays a graph, which has no per-layer spans)."""
  eager = rec.get('eager')
  by = _spans.device_by_span(eager) if eager else None
  if not by or name not in by:
    return None
  return by[name][0] / 1e3 / eager['calls']


def moe_span_ms(rec):
  """Device ms a dream step of the operations launched inside `dsv2.moe`
  spans (the MoE layers' norm, router, experts and residual add)."""
  return _span_ms(rec, 'dsv2.moe')


def attn_span_ms(rec):
  """Device ms a dream step of the operations launched inside `dsv2.attn`
  spans (every layer's norm, MLA and residual add)."""
  return _span_ms(rec, 'dsv2.attn')
