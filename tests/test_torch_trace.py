"""The port's tracer (boxlcd_tpu_torch/trace.py): spans and counters, the
NGS iteration count of the plain physics, and the spans of the collection
dispatch, of the fused dream call and of the learned env's step, all on
the CPU through the program's own entry points.

Marked `cuda` (run on the card with `python -m pytest
tests/test_torch_trace.py -m cuda`): a span holds the device interval of a
kernel it launched and synchronised, on torch.profiler's clock; the
megakernel's counted instance gives the uncounted one's states and poses
bit for bit and the plain path's NGS count world for world.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.data.collect import make_mega_rollout_fn
from boxlcd_tpu_torch.engine import cuda_solver, mega, physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import cuda_raster, traj_raster
from boxlcd_tpu_torch.research.nets import moe_kernel
from boxlcd_tpu_torch.research.scripts.exit_probe import probe_step

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ITERS = {'vel_iters': 8, 'pos_iters': 4}


@pytest.fixture(autouse=True)
def tracing_off():
  """Each test starts and ends with tracing off and nothing recorded."""
  trace.stop()
  yield
  trace.stop()


def _env(name, **G):
  return boxlcd_tpu_torch.env_map[name](dict(ITERS, **G), device='cpu')


def test_tracing_off_records_nothing():
  assert not trace.ON
  a, b = trace.span('x'), trace.span('y')
  assert a is b                        # one shared no-op context
  with a:
    with b:
      pass
  assert trace.world_counts(('c',), 4, 'cpu') is None
  trace.count('kept')                  # counters count either way
  rec = trace.stop()
  assert rec == {'spans': [], 'counters': {'kept': 1}}


def test_nested_spans_carry_parent_and_root():
  trace.start()
  with trace.span('call'):
    with trace.span('step'):
      with trace.span('inner'):
        pass
    with trace.span('step'):
      pass
  with trace.span('call'):
    with trace.span('step'):
      pass
  rec = trace.stop()
  got = [(s['name'], s['id'], s['parent'], s['root']) for s in rec['spans']]
  assert got == [('call', 0, -1, 0), ('step', 1, 0, 0), ('inner', 2, 1, 0),
                 ('step', 3, 0, 0), ('call', 4, -1, 4), ('step', 5, 4, 4)]
  by = {s['id']: s for s in rec['spans']}
  for s in rec['spans']:
    assert s['start_us'] <= s['end_us']
    if s['parent'] >= 0:
      p = by[s['parent']]
      assert p['start_us'] <= s['start_us'] <= s['end_us'] <= p['end_us']
  # on the wall clock (time.time_ns), the clock of the profiler's events
  import time
  assert abs(rec['spans'][0]['start_us'] - time.time_ns() / 1e3) < 60e6


def test_stop_clears():
  """stop() clears the spans and buffers; its record counts from start(),
  while the counters themselves only grow."""
  trace.count('n', 5)                  # before start(): not in the record
  before = trace.counter('n')
  trace.start()
  with trace.span('a'):
    trace.count('n', 3)
  buf = trace.world_counts(('w.x', 'w.y'), 2, 'cpu')
  buf += torch.tensor([[1, 2], [3, 4]])
  assert trace.world_counts(('w.x', 'w.y'), 2, 'cpu') is buf
  rec = trace.stop()
  assert [s['name'] for s in rec['spans']] == ['a']
  assert rec['counters'] == {'n': 3, 'w.x': 4, 'w.y': 6}
  assert trace.stop() == {'spans': [], 'counters': {}}
  assert trace.counter('n') == before + 3 and not trace.ON
  assert trace.counter('w.x') >= 4


def test_counters_only_grow():
  """A reader's before/after difference holds across start() and stop():
  neither moves a counter."""
  before = trace.counter('k.launches')
  trace.start()
  trace.count('k.launches')
  mid = trace.counter('k.launches')
  rec = trace.stop()
  trace.count('k.launches', 2)
  trace.start()
  assert trace.counter('k.launches') - before == 3
  assert mid - before == 1 and rec['counters'] == {'k.launches': 1}
  assert trace.stop()['counters'] == {}


def test_world_counts_one_buffer_per_shape():
  """A buffer for each (names, worlds, device), zeroed at start()."""
  trace.start()
  a = trace.world_counts(('w.x',), 2, 'cpu')
  b = trace.world_counts(('w.x',), 3, 'cpu')
  assert a is not b and a.shape == (2, 1) and b.shape == (3, 1)
  a += 1
  b += 2
  assert trace.stop()['counters'] == {'w.x': 2 + 6}
  trace.start()
  assert int(trace.world_counts(('w.x',), 2, 'cpu').sum()) == 0
  assert trace.stop()['counters'] == {}


def test_span_closes_on_error():
  """A span whose body raises still ends, and the next span is a root."""
  trace.start()
  with pytest.raises(ValueError):
    with trace.span('outer'):
      with trace.span('inner'):
        raise ValueError
  with trace.span('next'):
    pass
  rec = trace.stop()
  got = [(s['name'], s['parent']) for s in rec['spans']]
  assert got == [('outer', -1), ('inner', 0), ('next', -1)]


def test_spanned_wraps_a_function():
  """spanned(name) runs each call inside span(name), keeps the function's
  name, arguments and result, and records nothing while tracing is off."""
  @trace.spanned('f.call')
  def f(x, y=1):
    """doc"""
    with trace.span('f.inner'):
      return x + y
  assert f.__name__ == 'f' and f.__doc__ == 'doc'
  assert f(1, y=2) == 3
  trace.start()
  assert f(2) == 3
  rec = trace.stop()
  assert [(s['name'], s['parent']) for s in rec['spans']] == [
      ('f.call', -1), ('f.inner', 0)]
  assert f(3) == 4 and trace.stop()['spans'] == []


# the launch counters the five kernel wrappers used to keep as module
# globals, and the grouped-expert kernels' since, by the tracer name they
# count under
LAUNCH_COUNTERS = {'mega_rollout.launches': mega,
                   'traj_raster.launches': traj_raster,
                   'lcd_raster.launches': cuda_raster,
                   'solver.velocity.launches': cuda_solver,
                   'solver.substep.launches': cuda_solver,
                   'moe_gate_up.launches': moe_kernel,
                   'moe_down.launches': moe_kernel,
                   'moe_combine.launches': moe_kernel}
# the megakernel's counted instance counts under a name of its own too
COUNTED = 'mega_rollout.counted_launches'


def test_launch_counters_moved_into_the_tracer():
  """One counter system: no wrapper keeps a LAUNCHES global, each counts
  its launches in the tracer under the name chip_smoke.py and
  bench_bisect read, and a counter counts as the globals did."""
  for mod in set(LAUNCH_COUNTERS.values()):
    assert not hasattr(mod, 'LAUNCHES')
  counted = set()
  for mod in set(LAUNCH_COUNTERS.values()):
    src = Path(mod.__file__).read_text()
    counted |= set(re.findall(r"trace\.count\('([\w.]+\.launches)'\)", src))
    counted |= {f'solver.{k}.launches' for k in ('velocity', 'substep')
                if "trace.count(f'solver.{kind}.launches')" in src}
  assert counted == set(LAUNCH_COUNTERS)
  assert f"trace.count('{COUNTED}')" in Path(mega.__file__).read_text()
  smoke = (ROOT / 'chip_smoke.py').read_text()
  assert set(re.findall(r"'([\w.]+\.launches)'", smoke)) == counted
  before = trace.counter('mega_rollout.launches')
  trace.count('mega_rollout.launches')
  assert trace.counter('mega_rollout.launches') == before + 1
  snap = trace.counters()
  trace.count('mega_rollout.launches', 2)
  assert snap['mega_rollout.launches'] == before + 1


def test_plain_rollout_counts_ngs_iterations():
  """physics.step_world_motor counts each world's NGS iterations: a world
  whose bodies touch nothing and have no joint (Dropbox's falling box)
  exits after the first iteration, 1 a substep; none runs more than
  pos_iters; the tracer's buffer gets the same counts."""
  env = _env('Dropbox')
  spec = env.spec
  B = 6
  st = Env.reset(env, torch.Generator().manual_seed(0), B)
  ms = torch.zeros((1, B, len(spec.j_parent)))
  counts = torch.zeros((B, 2), dtype=torch.int64)
  mega.make_rollout(spec, 1).plain_rollout(st, ms, counts=counts)
  assert counts.tolist() == [[spec.substeps, spec.substeps]] * B
  env = _env('Urchin')
  spec = env.spec
  gen = torch.Generator().manual_seed(1)
  st = Env.reset(env, gen, B)
  T = 3
  u = torch.rand((B, T, env.act_size), generator=gen) * 2 - 1
  ms = physics.motor_speeds(spec, u).transpose(0, 1).contiguous()
  counts = torch.zeros((B, 2), dtype=torch.int64)
  rollout = mega.make_rollout(spec, T)
  rollout.plain_rollout(st, ms, counts=counts)
  subs = T * spec.substeps
  assert counts[:, 1].tolist() == [subs] * B
  assert (counts[:, 0] >= subs).all()
  assert (counts[:, 0] <= spec.pos_iters * subs).all()
  assert int(counts[:, 0].sum()) > subs * B      # contacts and joints work
  trace.start()
  rollout(st, ms)                                 # the CPU: the plain path
  rec = trace.stop()
  assert rec['counters']['physics.ngs_iters'] == int(counts[:, 0].sum())
  assert rec['counters']['physics.world_substeps'] == subs * B


def test_ngs_count_is_the_box2d_exit():
  """A world's count is the iterations up to and including the first whose
  Box2D exit flag is set (exit_probe's flags), pos_iters where none is."""
  env = _env('Urchin')
  spec = env.spec
  gen = torch.Generator().manual_seed(2)
  B = 8
  st = Env.reset(env, gen, B)
  act = torch.rand((B, env.act_size), generator=gen) * 2 - 1
  _, _, dones, _, _ = probe_step(spec, st, act)   # (substeps, B, pos_iters)
  want = (1 + (~dones[..., :-1]).sum(-1)).sum(0)
  counts = torch.zeros((B, 2), dtype=torch.int64)
  physics.step_world_motor(spec, st, physics.motor_speeds(spec, act),
                           counts=counts)
  assert counts[:, 0].tolist() == want.tolist()


def _tiny_collect(traced):
  env = _env('Urchin', ep_len=4)
  fn, T = make_mega_rollout_fn(env, pack_lcd=True)
  if traced:
    trace.start()
  out = fn(torch.Generator().manual_seed(3), 4)
  return out, T, trace.stop() if traced else None


def test_collect_dispatch_spans_change_nothing():
  want, T, _ = _tiny_collect(False)
  got, _, rec = _tiny_collect(True)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  spans = rec['spans']
  root, = [s for s in spans if s['name'] == 'collect.dispatch']
  names = {s['name'] for s in spans if s['parent'] == root['id']}
  assert names == {'collect.reset', 'collect.actions', 'collect.glue',
                   'collect.megakernel', 'collect.raster', 'collect.tripwire'}
  assert all(s['root'] == root['id'] for s in spans)
  c = rec['counters']
  assert c['physics.world_substeps'] == 4 * T * 3   # the CPU's plain physics
  assert 0 < c['physics.ngs_iters'] <= ITERS['pos_iters'] * 4 * T * 3


def _tiny_dream(tmp_path, monkeypatch):
  """A PPO whose env is RewardLenv(LearnedEnv) over a tiny FBT over a BVAE
  (test_torch_ppo_lenv.py's widths, 4 envs, window 6, ep_len 6), and the
  state a fused dream epoch starts from."""
  from boxlcd_tpu_torch.research import utils as rutils
  from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
  from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
  from boxlcd_tpu_torch.research.rl.main import parse
  from boxlcd_tpu_torch.research.rl.ppo import PPO
  from boxlcd_tpu_torch.research.wrappers import LearnedEnv, RewardLenv
  monkeypatch.setattr(rutils, 'make_writer',
                      lambda logdir: rutils.NullWriter())
  G = parse(['--env=Urchin', '--device=cpu', '--num_envs=4',
             '--hidden_size=32', '--vel_iters=2', '--pos_iters=1',
             '--window=6', '--ep_len=6', f'--logdir={tmp_path}', 'ppo'])
  G.update(nfilter=8, vqD=4, vqK=16, n_embed=32, n_head=2, n_layer=1)
  torch.manual_seed(0)
  ppo = PPO(G)
  raw = ppo.tenv._env
  bvae = BVAE(raw, G)
  ppo.env = RewardLenv(LearnedEnv(4, FBT(raw, G, bvae=bvae), G,
                                  real_env=ppo.tenv))
  ppo.env.reset()
  lenv = ppo.env.lenv
  return ppo, (lenv.window_batch, lenv.ptr, lenv.ep_t, dict(ppo.env.goal))


def _same(a, b):
  """a and b hold equal values, leaf for leaf."""
  if isinstance(a, dict):
    return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
  if isinstance(a, (list, tuple)):
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
  if isinstance(a, torch.Tensor):
    return torch.equal(a, b)
  return bool(np.array_equal(a, b))


def test_dream_call_spans(tmp_path, monkeypatch):
  """PPO.lenv_rollout, 8 steps past a slide and a timeout: traced and
  untraced from one generator state give the same call, and the traced one
  is a dream.call over the pools it draws, 8 dream.step spans (the policy,
  onestep's four, the env) and the host copy."""
  ppo, start = _tiny_dream(tmp_path, monkeypatch)
  gen_state = ppo.gen.get_state()
  want = ppo.lenv_rollout(*start, 8)
  ppo.gen.set_state(gen_state)
  trace.start()
  got = ppo.lenv_rollout(*start, 8)
  rec = trace.stop()
  assert _same(got, want)
  spans = rec['spans']
  call, = [s for s in spans if s['name'] == 'dream.call']
  assert call['parent'] == -1 and all(s['root'] == call['id'] for s in spans)
  kids = [s['name'] for s in spans if s['parent'] == call['id']]
  assert kids == ['dream.pools'] + ['dream.step'] * 8 + ['dream.host_copy']
  for step in [s for s in spans if s['name'] == 'dream.step']:
    assert [s['name'] for s in spans if s['parent'] == step['id']] == [
        'dream.policy', 'onestep.encode', 'onestep.fbt', 'onestep.draw',
        'onestep.decode', 'dream.env']


def test_learned_env_step_has_the_onestep_spans(tmp_path, monkeypatch):
  """LearnedEnv.step (the per-step learned env) gets FBT.onestep's spans."""
  ppo, _ = _tiny_dream(tmp_path, monkeypatch)
  lenv = ppo.env.lenv
  trace.start()
  lenv.step(torch.zeros((4, lenv.raw_env.act_size)))
  rec = trace.stop()
  assert [s['name'] for s in rec['spans']] == [
      'onestep.encode', 'onestep.fbt', 'onestep.draw', 'onestep.decode']
  assert [s['parent'] for s in rec['spans']] == [-1] * 4


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  return torch.device('cuda')


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_profiler_clock(cuda_device):
  """A span around torch.cuda._sleep and a synchronise holds the sleep
  kernel's device interval as torch.profiler stamps it, and the launch's
  runtime call."""
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
  events = [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3, e.correlation_id(),
             e.device_type() == torch.autograd.DeviceType.CUDA)
            for e in prof.profiler.kineto_results.events()]
  kern = [e for e in events if e[4] and 'spin_kernel' in e[0]]
  assert len(kern) == 1
  _, ks, ke, corr, _ = kern[0]
  launch = [e for e in events if not e[4] and e[3] == corr
            and e[0].startswith('cuda')]     # the runtime call, no marker
  assert [e[0] for e in launch] == ['cudaLaunchKernel']
  assert sp['start_us'] <= launch[0][1] <= ks < ke <= sp['end_us']
  assert ke - ks > 1000          # the sleep, not a stray event


@pytest.mark.cuda
def test_counted_megakernel_equals_uncounted_and_plain(cuda_device):
  """At 180/60, 64 worlds x 5 steps: the counted instance's states and
  poses equal the uncounted instance's bit for bit, and its NGS count
  equals the plain path's world for world."""
  env = boxlcd_tpu_torch.env_map['Urchin'](
      {'vel_iters': 180, 'pos_iters': 60}, device=cuda_device)
  spec = env.spec
  B, T = 64, 5
  gen = torch.Generator(device=cuda_device).manual_seed(11)
  st = Env.reset(env, gen, B)
  u = torch.rand((B, T, env.act_size), generator=gen, device=cuda_device)
  ms = physics.motor_speeds(spec, u * 2 - 1).transpose(0, 1).contiguous()
  rollout = mega.make_rollout(spec, T)
  plain_new, plain_traj = rollout.kernel_rollout(st, ms)
  counts = torch.zeros((B, 2), dtype=torch.int64, device=cuda_device)
  new, traj = rollout.kernel_rollout(st, ms, counts=counts)
  torch.cuda.synchronize()
  for f in physics.WorldState._fields:
    assert torch.equal(getattr(new, f), getattr(plain_new, f)), f
  assert torch.equal(traj['stream'], plain_traj['stream'])
  ref = torch.zeros((B, 2), dtype=torch.int64, device=cuda_device)
  rollout.plain_rollout(st, ms, counts=ref)
  assert counts[:, 1].tolist() == [T * spec.substeps] * B
  assert torch.equal(counts, ref), (counts[:, 0] - ref[:, 0]).tolist()
  per = counts[:, 0].double() / counts[:, 1].double()
  assert float(per.min()) >= 1 and float(per.max()) <= spec.pos_iters
  # the tracer's buffer while tracing is on; none while it is off
  trace.start()
  rollout(st, ms)
  rec = trace.stop()
  assert rec['counters']['mega_rollout.launches'] == 1
  assert rec['counters'][COUNTED] == 1
  assert rec['counters']['mega_rollout.ngs_iters'] == int(counts[:, 0].sum())
  assert rec['counters']['mega_rollout.world_substeps'] == \
      B * T * spec.substeps
