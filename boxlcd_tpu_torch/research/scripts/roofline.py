"""Megakernel roofline: operations and bytes of one env step of one world,
and, with a measured rate, the shares of the H100's peaks (the port of
research/scripts/roofline.py, rethought for the card).

Operations, two counts:
- the aten ops of one plain `physics.step_world_batch` at B = 1, counted
  through a TorchDispatchMode (`count_flops`): output elements x COST,
  matmuls 2*M*N*K, moves, reductions and factories free: the rules and
  costs of the JAX script's jaxpr walk, keyed by aten op;
- `mega_flops_per_substep`, the hand count of csrc/physics_stages.cuh that
  the megakernel's bound in chip_smoke.py uses (`mega_bound`).
  One form counts apart: a scalar over a tensor (`1.0 / x`) is a
  reciprocal and a multiply in aten (3 an element), a div (2) in a jaxpr.
Bytes: what csrc/mega_rollout.cu moves for one world: each step's poses out
((x, y, angle) a body) and motor speeds in (every joint slot), and the
WorldState read and written once a launch of T steps.
Peaks: the H100 SXM's published 67 TFLOP/s float32 outside the tensor cores
and 3.35 TB/s HBM3; a share is printed beside the card's name and power
limit (nvidia-smi, or the bench line's `card`).

    python -m boxlcd_tpu_torch.research.scripts.roofline --env=Urchin \
        [--iters=8,4] [--device=cpu] \
        [--steps_per_sec='<the port bench's JSON line, or a rate>']
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import boxlcd_tpu_torch
from boxlcd_tpu_torch.bench import card_line
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.engine.spec import CIRCLE
from boxlcd_tpu_torch.envs.env import Env

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
FP32_FLOPS = 67e12                          # H100 SXM, outside the tensor cores

# per-element costs, the JAX script's COST keyed by aten op (in-place forms
# share their op's cost): max/min -> maximum, minimum, clamp_min, clamp_max;
# select_n -> where; clamp -> clamp with both bounds; integer_pow -> pow
# with an integer exponent; logistic -> sigmoid; dot_general -> the matmuls
COST = {
    'add': 1, 'sub': 1, 'rsub': 1, 'mul': 1, 'div': 2, 'reciprocal': 2,
    'maximum': 1, 'minimum': 1, 'clamp_min': 1, 'clamp_max': 1, 'neg': 1,
    'abs': 1, 'where': 1, 'clamp': 2, 'sign': 1, 'floor': 1, 'ceil': 1,
    'round': 1, 'remainder': 2, 'fmod': 2, 'pow': 8, 'sqrt': 4, 'rsqrt': 4,
    'sin': 8, 'cos': 8, 'tan': 10, 'atan2': 12, 'exp': 8, 'log': 8,
    'tanh': 10, 'sigmoid': 8, 'mm': 2, 'bmm': 2, 'addmm': 2, 'mv': 2,
    'dot': 2, 'eq': 1, 'ne': 1, 'lt': 1, 'le': 1, 'gt': 1, 'ge': 1,
    'logical_and': 1, 'bitwise_and': 1, 'logical_or': 1, 'bitwise_or': 1,
    'logical_not': 1, 'bitwise_not': 1, 'logical_xor': 1, 'bitwise_xor': 1,
}
_MATMULS = ('mm', 'bmm', 'addmm', 'mv', 'dot')


def _numel(x):
  if isinstance(x, torch.Tensor):
    return x.numel()
  if isinstance(x, (tuple, list)):
    return max([_numel(y) for y in x] or [1])
  return 1


def op_flops(name, args, kwargs, out):
  """Float operations of one aten call by the JAX script's rules, or 0."""
  name = name[:-1] if name.endswith('_') else name
  c = COST.get(name)
  if c is None:
    return 0
  if name == 'clamp':        # one bound is a max or a min
    lo = args[1] if len(args) > 1 else kwargs.get('min')
    hi = args[2] if len(args) > 2 else kwargs.get('max')
    c = 2 if lo is not None and hi is not None else 1
  if name == 'pow' and not isinstance(args[0], torch.Tensor):
    pass                     # scalar ** tensor: pow
  elif name == 'pow' and not isinstance(args[1], torch.Tensor) and \
      float(args[1]).is_integer():
    c = 2                    # integer_pow
  size = max(1, _numel(out))
  if name in _MATMULS:
    a = args[1] if name == 'addmm' else args[0]
    size *= int(a.shape[-1])  # 2*M*N*K: M*N out elements, K contracted
  return c * size


class FlopCounter(TorchDispatchMode):
  """Sums op_flops over every aten call made inside it; `by_op` keeps the
  per-op totals."""

  def __init__(self):
    super().__init__()
    self.total = 0
    self.by_op = {}

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    name = func.overloadpacket.__name__
    f = op_flops(name, args, kwargs, out)
    if f:
      self.total += f
      key = name[:-1] if name.endswith('_') else name
      self.by_op[key] = self.by_op.get(key, 0) + f
    return out


def count_flops(fn, *args):
  """(float operations, {aten op: operations}) of one call of fn."""
  with FlopCounter() as counter:
    fn(*args)
  return counter.total, counter.by_op


def step_flops(env, gen=None):
  """(operations, per-op totals, the state after) of ONE plain env step of
  ONE world: step_world_batch at B = 1 from a reset, under FlopCounter."""
  gen = gen or torch.Generator(device=env.device).manual_seed(0)
  state = Env.reset(env, gen, 1)
  act = torch.rand((1, env.act_size), generator=gen, device=env.device) * 2 - 1
  out = {}

  def step():
    out['state'] = physics.step_world_batch(env.spec, state, act)
  total, by_op = count_flops(step)
  return total, by_op, out['state']


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


def contacts_per_world(state):
  """Touching contact points per world of a WorldState (walls and pairs)."""
  B = state.c.shape[0]
  return float(((state.wc_id >= 0).sum() + (state.pc_id >= 0).sum()) / B)


def state_bytes(state):
  """Bytes of a WorldState batch."""
  return sum(getattr(state, f).numel() * getattr(state, f).element_size()
             for f in physics.WorldState._fields)


def mega_bytes(spec, state, B, T):
  """Bytes csrc/mega_rollout.cu moves in one launch of T steps over B
  worlds: the WorldState read and written once, the (T, B, J) motor speeds
  read once, the (T, N, 3, B) pose stream written once."""
  return (2 * state_bytes(state) + T * B * len(spec.j_parent) * 4
          + T * spec.n * 3 * B * 4)


def mega_bound(spec, final, B, T):
  """Least time of one megakernel call: (bound ms, 'bytes' | 'operations',
  flops). Operations: mega_flops_per_substep with C the contact points
  touching in the final state (this run's data), x substeps x T x B.
  Bytes: mega_bytes."""
  flops = (mega_flops_per_substep(spec, contacts_per_world(final))
           * spec.substeps * T * B)
  t_bytes = mega_bytes(spec, final, B, T) / HBM_BYTES_PER_S * 1e3
  t_ops = flops / FP32_FLOPS * 1e3
  by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
  return (*by, flops)


def parse_rate(text):
  """--steps_per_sec: a number, or the port bench's JSON line (its
  `value` and `card`). Returns (rate, card or None)."""
  text = str(text).strip()
  if text.startswith('{'):
    rec = json.loads(text)
    return float(rec['value']), rec.get('card')
  return float(text), None


def report(env, T, rate=0.0, card=None, worlds=4096):
  """Print the roofline of `env`; returns its numbers as a dict."""
  spec = env.spec
  f, by_op, after = step_flops(env)
  hand = mega_flops_per_substep(spec, contacts_per_world(after)) \
      * spec.substeps
  one = physics.init_state(spec, 1, env.device)
  stream = (spec.n * 3 + len(spec.j_parent)) * 4
  per_step = mega_bytes(spec, one, 1, T) / T
  print(f'== {env.__class__.__name__} @ {spec.vel_iters}/{spec.pos_iters} '
        f'(substeps={spec.substeps}) ==')
  print(f'FLOPs/env-step/world, plain step at B=1 (aten dispatch count): '
        f'{f:,.0f}')
  print('  by op: ' + ', '.join(f'{k} {v:,.0f}' for k, v in sorted(
      by_op.items(), key=lambda kv: -kv[1])))
  print(f'FLOPs/env-step/world, physics_stages.cuh hand count '
        f'(mega_flops_per_substep x {spec.substeps}): {hand:,.0f}')
  print(f'bytes/env-step/world, mega_rollout.cu: {stream} streamed (poses '
        f'out, motor speeds in) + {2 * state_bytes(one)} of state a launch '
        f'of T={T}: {per_step:,.1f}')
  print(f'arithmetic intensity: {hand / per_step:,.0f} FLOP/byte (hand '
        f'count) vs the H100 balance {FP32_FLOPS / HBM_BYTES_PER_S:.1f}')
  out = dict(flops=f, by_op=by_op, hand_flops=hand, bytes=per_step,
             stream_bytes=stream)
  if rate > 0:
    if card is None:      # a bare rate: the card is this run's, if any
      card = (card_line(env.device) if env.device.type == 'cuda'
              else 'card not given')
    for label, flops in (('dispatch count', f), ('hand count', hand)):
      achieved = flops * rate
      share = achieved / FP32_FLOPS
      print(f'measured {rate:,.1f} steps/s @ {worlds} worlds ({card}): '
            f'{achieved / 1e12:.4f} TFLOP/s float32 by the {label} = '
            f'{100 * share:.3f}% of {FP32_FLOPS / 1e12:g} TFLOP/s')
      out[f'flop_share_{label.split()[0]}'] = share
    bw = per_step * rate
    print(f'  HBM {bw / 1e9:.3f} GB/s = {100 * bw / HBM_BYTES_PER_S:.4f}% of '
          f'{HBM_BYTES_PER_S / 1e12:g} TB/s ({card})')
    out.update(rate=rate, card=card, hbm_share=bw / HBM_BYTES_PER_S)
  return out


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--env', default='Urchin')
  parser.add_argument('--iters', default='8,4')
  parser.add_argument('--steps_per_sec', default='0',
                      help="a rate, or the port bench's JSON line")
  parser.add_argument('--worlds', type=int, default=4096)
  parser.add_argument('--T', type=int, default=100,
                      help='steps a megakernel launch (the bench chunk)')
  parser.add_argument('--device', default=None)
  args = parser.parse_args(argv)
  vi, pi = (int(x) for x in args.iters.split(','))
  env = boxlcd_tpu_torch.env_map[args.env](
      {'vel_iters': vi, 'pos_iters': pi}, device=args.device)
  rate, card = parse_rate(args.steps_per_sec)
  return report(env, args.T, rate, card, args.worlds)


if __name__ == '__main__':
  main()
