"""The port's measurement scripts on the CPU: roofline's aten dispatch
counter against the JAX script's jaxpr walk, exit_probe's instrumented step
against JAX's probe_step, and benchmark_e2e's record (bench_bisect's
stages: tests/test_torch_tools.py).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.engine import physics as jphys
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research.scripts import (
    benchmark_e2e, exit_probe, roofline)
from research.scripts import exit_probe as jexit_probe
from research.scripts import roofline as jroofline
from tests.parity import make_env as jmake_env

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

X = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
Y = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
A = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
M = np.random.default_rng(3).standard_normal((8, 3)).astype(np.float32)
FUNCS = {
    'arith': (lambda np_: lambda x, y: np_.sqrt(x * x + y * y) / (y - 2.0)
              - (x - 1.0) / (x + 3.0), (X, Y)),
    # lax.select: jnp.where wraps its select_n in a nested `jit`
    # equation, which the JAX script's walk skips (it knows `pjit`)
    'where': (lambda np_: lambda x, y: (
        jax.lax.select if np_ is jnp else torch.where)(x > 0, x, -x)
        * np_.exp(y), (X, Y)),
    'transcendental': (lambda np_: lambda x, y: np_.sin(x) + np_.cos(y)
                       * np_.tanh(x) + np_.abs(np_.maximum(x, y)
                                               - np_.minimum(x, y)),
                       (X, Y)),
    'compare': (lambda np_: lambda x, y: ((x >= y) & (x < 1.0))
                | (y == 0.5), (X, Y)),
    'matmul': (lambda np_: lambda a, m: a @ m + 1.0, (A, M)),
}


@pytest.mark.parametrize('name', sorted(FUNCS))
def test_dispatch_counter_equals_jaxpr_flops(name):
  make, args = FUNCS[name]
  want = jroofline.jaxpr_flops(jax.make_jaxpr(make(jnp))(*args).jaxpr)
  got, by_op = roofline.count_flops(make(torch),
                                    *(torch.as_tensor(a) for a in args))
  print(name, got, want, by_op)
  assert got == want > 0


# the JAX step's scans over joint and pair SLOTS, by the function of their
# body: the jnp path runs every slot, valid or not (masked), where the
# port's plain step skips invalid pair slots and unused joint slots
_SLOT_SCANS = {'joint_pass.<locals>.one_joint': lambda s: s.jn,
               'pair_pass.<locals>.one_pair': lambda s: int(
                   np.sum(s.pair_valid)),
               'pos_iter.<locals>.one_pair_slot': lambda s: 2 * int(
                   np.sum(s.pair_valid)),
               'pos_iter.<locals>.one_joint': lambda s: s.jn}


def _engine_fn(eqn):
  tb = eqn.source_info.traceback
  for fr in (tb.frames if tb else []):
    if 'boxlcd_tpu/engine' in fr.file_name:
      return fr.function_name
  return ''


def _eqn_flops(eqn):
  """jroofline.jaxpr_flops' rule for one primitive equation."""
  c = jroofline.COST.get(eqn.primitive.name)
  if c is None:
    return 0
  size = max([int(np.prod(v.aval.shape)) if v.aval.shape else 1
              for v in eqn.outvars] + [1])
  if eqn.primitive.name == 'dot_general':
    a = eqn.invars[0].aval
    ((cdims, _), _) = eqn.params['dimension_numbers']
    size *= int(np.prod([a.shape[d] for d in cdims])) if a.shape else 1
  return c * size


def jaxpr_flops_valid(jaxpr, spec, valid=True):
  """jroofline.jaxpr_flops with nested `jit` equations walked (the JAX
  script knows them as `pjit` and skips them under this JAX: every
  jnp.where's select_n) and, with `valid`, the scans over joint and pair
  slots taken over the spec's valid slots only; returns (total,
  per-primitive)."""
  total, by = 0.0, {}

  def walk(jx, mult):
    nonlocal total
    for eqn in jx.eqns:
      prim = eqn.primitive.name
      if prim == 'scan':
        body = eqn.params['jaxpr'].jaxpr
        fns = {_engine_fn(e) for e in body.eqns}
        n = int(eqn.params['length'])
        for suffix, n_valid in _SLOT_SCANS.items():
          if valid and any(f.endswith(suffix) for f in fns):
            n = n_valid(spec)
        walk(body, mult * n)
        continue
      if prim in ('while', 'cond', 'pjit', 'jit', 'closed_call',
                  'custom_jvp_call', 'custom_vjp_call', 'remat',
                  'checkpoint'):
        sub = (eqn.params.get('body_jaxpr') or eqn.params.get('jaxpr')
               or eqn.params.get('call_jaxpr'))
        if prim == 'cond':
          sub = eqn.params['branches'][-1]
        walk(sub.jaxpr if hasattr(sub, 'jaxpr') else sub, mult)
        continue
      f = _eqn_flops(eqn)
      total += f * mult
      if f:
        by[prim] = by.get(prim, 0) + f * mult

  walk(jaxpr, 1)
  return total, by


@pytest.mark.parametrize('env_name', ['Dropbox', 'Urchin'])
def test_plain_step_count_within_factor_2_of_jax(env_name):
  """One plain step of one world at 8/4: the dispatch count against JAX's
  step_flops over the same valid slots, within a factor 2. The full JAX
  count (every slot) is printed beside it: Dropbox's one body carries a
  pair slot and a joint slot that are never valid, whose masked work the
  jnp step runs and the port's skips."""
  G = {'vel_iters': 8, 'pos_iters': 4}
  jenv = boxlcd_tpu.env_map[env_name](G)
  tenv = boxlcd_tpu_torch.env_map[env_name](G, device='cpu')
  full = jroofline.step_flops(jenv)
  state = jax.eval_shape(lambda k: JEnv.reset(jenv, k), jax.random.PRNGKey(0))
  act = jax.ShapeDtypeStruct((jenv.act_size,), jnp.float32)
  jx = jax.make_jaxpr(lambda s, a: jphys.step_world(jenv.spec, s, a))(
      state, act).jaxpr
  want, jby = jaxpr_flops_valid(jx, jenv.spec)
  every = jaxpr_flops_valid(jx, jenv.spec, valid=False)[0]
  got, by_op, _ = roofline.step_flops(tenv)
  print(f'{env_name}: port {got:,.0f}; JAX over valid slots {want:,.0f} '
        f'(ratio {got / want:.3f}); JAX every slot {every:,.0f} (ratio '
        f'{got / every:.3f}); the JAX script\'s step_flops {full:,.0f} '
        f'(ratio {got / full:.3f})')
  print('  port by op:', dict(sorted(by_op.items(), key=lambda kv: -kv[1])))
  print('  JAX by primitive:', dict(sorted(jby.items(),
                                           key=lambda kv: -kv[1])))
  assert 0.5 <= got / want <= 2.0


def test_mega_bound_counts_from_roofline():
  """chip_smoke.py's megakernel bound is roofline's: the operations of
  mega_flops_per_substep x substeps x T x B, the bytes of mega_bytes."""
  env = boxlcd_tpu_torch.env_map['Urchin']({'vel_iters': 8, 'pos_iters': 4},
                                           device='cpu')
  spec = env.spec
  st = Env.reset(env, torch.Generator().manual_seed(0), 16)
  ms, by, flops = roofline.mega_bound(spec, st, 16, 10)
  C = roofline.contacts_per_world(st)
  assert flops == roofline.mega_flops_per_substep(spec, C) * 3 * 10 * 16
  nbytes = roofline.mega_bytes(spec, st, 16, 10)
  assert ms == max(nbytes / roofline.HBM_BYTES_PER_S,
                   flops / roofline.FP32_FLOPS) * 1e3
  assert by == ('operations' if flops / roofline.FP32_FLOPS
                > nbytes / roofline.HBM_BYTES_PER_S else 'bytes')
  rate, card = roofline.parse_rate('{"value": 1000.0, "card": "X, 1 W"}')
  assert (rate, card) == (1000.0, 'X, 1 W')
  out = roofline.report(env, 10, rate, card)
  assert out['flop_share_dispatch'] == out['flops'] * 1000.0 / 67e12


def test_exit_probe_matches_jax_probe_step():
  """exit_probe.probe_step at 8/4, B = 4, T = 1 from JAX's resets and
  actions: each sweep's dm, the NGS done flags and the block activity."""
  B = 4
  G = {'vel_iters': 8, 'pos_iters': 4}
  jenv = jmake_env('Urchin', G)
  sts = []
  for i in range(B):
    jenv.seed(i)
    jenv.reset()
    sts.append(jenv.state)
  jstates = jax.tree.map(lambda *x: jnp.stack(x), *sts)
  act = np.random.RandomState(0).uniform(-1, 1, (B, jenv.act_size)).astype(
      np.float32)
  _, jdms, jdones, jw, jp = jax.jit(
      lambda s, a: jexit_probe.probe_step(jenv.spec, s, a))(jstates, act)
  tenv = exit_probe.make_env('Urchin', G, 'cpu')
  tstates = physics.state_from_numpy(jstates, 'cpu')
  _, dms, dones, w, p = exit_probe.probe_step(tenv.spec, tstates,
                                              torch.as_tensor(act))
  jdms = np.asarray(jdms)
  assert dms.shape == jdms.shape == (3, B, 8)
  err = np.abs(dms - jdms)
  print('dm max err', err.max(), 'dm max', jdms.max())
  assert err.max() < 1e-5 + 1e-4 * np.abs(jdms).max()
  assert np.array_equal(dones, np.asarray(jdones))
  assert np.array_equal(w, np.asarray(jw)) and np.array_equal(
      p, np.asarray(jp))
  rep = exit_probe.report('Urchin', tenv.spec, dms[None], dones[None],
                          w[None], p[None])
  assert rep['tol']['exact-0']['max'] <= 8 and 0 <= rep['wall_active'] <= 1


def test_benchmark_e2e_record(tmp_path, monkeypatch, capsys):
  """The JSON record's keys, at sizes cut by monkeypatching."""
  collect = importlib.import_module('boxlcd_tpu_torch.data.collect')
  monkeypatch.setattr(collect, 'BARREL_SIZE', 4)
  monkeypatch.setattr(benchmark_e2e, 'SCALED', dict(
      n_eps=8, bvae_iters=2, fbt_iters=2, fbt=(16, 2, 1), window=4,
      num_envs=4, ep_len=5, bs=4))
  from boxlcd_tpu_torch.research import utils as tutils
  monkeypatch.setattr(tutils, 'make_writer',
                      lambda logdir: tutils.NullWriter())
  monkeypatch.setenv('BOXLCD_DEFAULT_ITERS', '2,1')
  spec = importlib.import_module('boxlcd_tpu_torch.engine.spec')
  monkeypatch.setattr(spec, 'DEFAULT_ITERS', (2, 1))
  rec = benchmark_e2e.main(['--workdir', str(tmp_path), '--device=cpu'])
  assert set(rec) == {
      'metric', 'n_episodes', 'bvae_iters', 'fbt_iters', 'datagen_s',
      'bvae_s', 'total_s', 'measured_this_run_s', 'under_one_hour',
      'device', 'card'}
  assert rec['metric'] == 'e2e_datagen_plus_fbt_wallclock'
  assert rec['n_episodes'] == 8 and rec['device'] == 'cpu'
  assert rec['under_one_hour'] is True and rec['datagen_s'] > 0
  assert (tmp_path / 'fbt' / 'FBT.pkl').exists()
  assert len(list((tmp_path / 'data' / 'train').glob('*.tbarrel.npz'))) == 2
  # a rerun reuses the barrels and reports no datagen time
  rec = benchmark_e2e.main(['--workdir', str(tmp_path), '--device=cpu'])
  assert rec['datagen_s'] is None and rec['under_one_hour'] is None
