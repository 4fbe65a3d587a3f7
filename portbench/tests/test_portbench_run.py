"""The harness end to end at a tiny size on the CPU (the look for a card
skipped), the faults it must catch, its control, its refusal to run without
a card, and the whole-name check for JAX."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.checks import mega_rollout as check
from portbench.reference import barrels

ROOT = Path(__file__).resolve().parents[2]
TINY_CONFIG = {'env_config': {'ep_len': 6}}
TINY = {
    'collect.urchin-ref': {
        'worlds': 2000, 'env_config': {'vel_iters': 8, 'pos_iters': 4},
        'check': {'worlds': 16, 'steps': 5}, 'host': {'barrel_size': 1000}},
    'rollout.urchin-fast': {
        'worlds': 16, 'pipeline': 2, 'env_config': {'vel_iters': 8,
                                                   'pos_iters': 4},
        'check': {'worlds': 16, 'steps': 5}},
}
DREAM_CONFIG = {
    'env_config': {'ep_len': 6, 'vel_iters': 2, 'pos_iters': 1},
    'bvae': {'hidden_size': 16, 'vqK': 16, 'vqD': 4, 'nfilter': 8,
             'window': 5},
    'fbt': {'n_embed': 32, 'n_head': 2, 'n_layer': 1, 'window': 6},
    'ppo': {'num_envs': 4, 'steps_per_epoch': 32, 'hidden_size': 32}}
TINY['dream.urchin-fbt'] = {'steps': 8, 'warm_steps': 7,
                            'check': {'steps': 3}}
CELLS = list(TINY)
COLLECTION = CELLS[:2]


def tiny_config(cell):
  return DREAM_CONFIG if cell.startswith('dream') else TINY_CONFIG


def tiny_run(cell, seed=2 ** 31 + 77, trace=0):
  return run.main(['--workload', cell, '--seed', str(seed), '--seconds',
                   '0.05', '--trace', str(trace)], device='cpu', root=ROOT,
                  overrides={'config': tiny_config(cell),
                             'traffic': TINY[cell]})


@pytest.mark.parametrize('cell', CELLS)
def test_tiny_run_is_correct(cell, capsys):
  res = tiny_run(cell)
  out, err = capsys.readouterr()
  line = json.loads(out.strip().splitlines()[-1])
  assert line == json.loads(json.dumps(res))
  assert res['correct'] and res['failed'] == 0 and res['attempted'] > 0
  assert list(line)[-1] == 'checks'
  assert set(line) >= {'correct', 'attempted', 'failed', 'metrics', 'device'}
  names = [f'check {k} ' for k in line['checks']]
  tail = err.strip().splitlines()[-len(names):]
  assert [t[:len(n)] for t, n in zip(tail, names)] == names
  entry = [w for w in json.loads((ROOT / 'BENCHMARK.json').read_text())[
      'workloads'] if w['name'] == cell][0]
  traffic = json.loads((ROOT / 'portbench/workloads' /
                        f'{entry["traffic"]}.json').read_text())
  assert set(line['metrics']) == {'setup_s', traffic['rate_metric']}
  assert line['device']['platform'] == 'cpu'


def test_tiny_traced_run_reports_no_device_metric_off_the_card():
  res = tiny_run('rollout.urchin-fast', trace=1)
  assert res['correct'] and res['metrics'] == {}
  assert 'busy_s' in res['device'] and 'window_s' in res['device']


def test_same_seed_same_answers():
  a = tiny_run('rollout.urchin-fast', seed=5)
  b = tiny_run('rollout.urchin-fast', seed=5)
  assert a['checks'] == b['checks'] and a['readings']['obs_gap_max'] == \
      b['readings']['obs_gap_max']


# -- faults planted under the timed path: each must make `correct` false ----

def _frozen(self, states, motor_speed):
  """A step that returns its state unchanged: the poses never move."""
  from boxlcd_tpu_torch.engine import mega
  B = states.c.shape[0]
  stream = torch.empty((self.T, self.spec.n, 3, B))
  stream[:, :, :2] = states.c.permute(1, 2, 0)
  stream[:, :, 2] = states.a.T
  return states, mega._traj(stream)


def _half(self, states, motor_speed):
  """Half of the batch left out: only the first half of the worlds is
  stepped; the rest keep their reset poses."""
  from boxlcd_tpu_torch.engine import mega, physics
  B = states.c.shape[0]
  h = B // 2
  first = physics.WorldState(*(x[:h] for x in states))
  _, traj = type(self)._plain(self, first, motor_speed[:, :h])
  _, still = _frozen(self, states, motor_speed)
  stream = still['stream'].clone()
  stream[..., :h] = traj['stream']
  return states, mega._traj(stream)


def _moved(self, states, motor_speed):
  """An answer altered where it is produced: every pose shifted by 0.01."""
  s, traj = type(self)._plain(self, states, motor_speed)
  from boxlcd_tpu_torch.engine import mega
  return s, mega._traj(traj['stream'] + 0.01)


def _flipped(self, poses, cosa, sina, is_circle):
  """An answer altered where it is produced: one pixel of every frame."""
  return type(self)._plain_rows(self, poses, cosa, sina, is_circle) ^ 1


@pytest.mark.parametrize('cell', COLLECTION)
@pytest.mark.parametrize('fault', ['frozen', 'half', 'moved', 'flipped'])
def test_fault_fails(cell, fault, monkeypatch):
  from boxlcd_tpu_torch.engine import mega
  from boxlcd_tpu_torch.render import traj_raster
  monkeypatch.setattr(mega.Rollout, '_plain', mega.Rollout.plain_rollout,
                      raising=False)
  monkeypatch.setattr(traj_raster.TrajRender, '_plain_rows',
                      traj_raster.TrajRender.plain_rows, raising=False)
  if fault == 'flipped':
    monkeypatch.setattr(traj_raster.TrajRender, 'plain_rows', _flipped)
  else:
    monkeypatch.setattr(mega.Rollout, 'plain_rollout',
                        {'frozen': _frozen, 'half': _half,
                         'moved': _moved}[fault])
  res = tiny_run(cell)
  assert not res['correct'], res['checks']


def _dream_unchanged(self, batch, i, gen, temp=1.0, u=None):
  """A step that returns its state unchanged: no frame is predicted."""
  return dict(batch)


def _dream_half(self, batch, i, gen, temp=1.0, u=None):
  """Half of the batch left out: the second half of the envs keeps its
  window."""
  out = type(self)._onestep(self, batch, i, gen, temp, u=u)
  h = batch['lcd'].shape[0] // 2
  return {k: torch.cat([v[:h], batch[k][h:]]) for k, v in out.items()}


def _dream_altered(self, batch, i, gen, temp=1.0, u=None):
  """An answer altered where it is produced: the predicted proprio
  shifted by 0.01."""
  out = type(self)._onestep(self, batch, i, gen, temp, u=u)
  out['proprio'] = out['proprio'].clone()
  out['proprio'][:, i] += 0.01
  return out


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
def test_dream_fault_fails(fault, monkeypatch):
  from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
  monkeypatch.setattr(FBT, '_onestep', FBT.onestep, raising=False)
  monkeypatch.setattr(FBT, 'onestep', {'unchanged': _dream_unchanged,
                                       'half': _dream_half,
                                       'altered': _dream_altered}[fault])
  res = tiny_run('dream.urchin-fbt')
  assert not res['correct'], res['checks']


# faults in the state the dream epoch carries from step to step: the
# program's own rollout with one statement taken out or switched off
CARRY_FAULTS = {
    # the window never takes the step's frame, action and slide
    'carry_dropped': ('wb[i] = wbi\n', 'pass\n'),
    # the window never slides at its last position
    'no_slide': ('if slide:\n', 'if False:\n'),
    # a timeout leaves the windows as they are
    'no_reset': ('wbi = self._fresh_wb(', 'wbi = wbi if True else self._fresh_wb('),
    # a row that is done keeps its goal
    'no_goal': ('goals[i] = {k: torch.where(',
                'goals[i] = gi if True else {k: torch.where('),
}


def _broken_rollout(fault):
  """PPO.lenv_rollout compiled from its source with one fault planted."""
  import inspect
  import textwrap
  from boxlcd_tpu_torch.research.rl import ppo
  src = textwrap.dedent(inspect.getsource(ppo.PPO.lenv_rollout))
  old, new = CARRY_FAULTS[fault]
  assert src.count(old) == 1, fault
  ns = {}
  exec(compile(src.replace(old, new), ppo.__file__, 'exec'),
       dict(vars(ppo)), ns)
  return ns['lenv_rollout']


@pytest.mark.parametrize('fault', sorted(CARRY_FAULTS))
def test_dream_carry_fault_fails(fault, monkeypatch):
  """The dream check holds the state a call carries between its steps:
  each of these faults leaves every single step right on the window it
  read, and still makes `correct` false."""
  from boxlcd_tpu_torch.research.rl.ppo import PPO
  monkeypatch.setattr(PPO, 'lenv_rollout', _broken_rollout(fault))
  res = tiny_run('dream.urchin-fbt')
  assert not res['correct'], res['checks']
  bad = {k for k, v in res['checks'].items() if not v['value'] <= v['limit']}
  assert bad & {'carry_obs_p50', 'carry_reward_p50', 'carry_frame_p50'}


def test_dream_policy_fault_fails(monkeypatch):
  """An answer altered where it is produced: the policy's value."""
  from boxlcd_tpu_torch.research.rl.nets import PPOActorCritic
  value = PPOActorCritic.value
  monkeypatch.setattr(PPOActorCritic, 'value',
                      lambda self, obs: value(self, obs) + 0.01)
  res = tiny_run('dream.urchin-fbt')
  assert not res['correct'], res['checks']


def test_tripwire_failure_fails(monkeypatch):
  """Frames that differ from the per-frame render of the same poses fail
  the program's own tripwire: the dispatch counts as failed."""
  from boxlcd_tpu_torch.render import traj_raster
  monkeypatch.setattr(traj_raster.TrajRender, '_plain_rows',
                      traj_raster.TrajRender.plain_rows, raising=False)
  monkeypatch.setattr(traj_raster.TrajRender, 'plain_rows', _flipped)
  res = tiny_run('rollout.urchin-fast')
  assert res['failed'] > 0 and not res['correct']


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_a_limit(cell):
  """The reference held in bfloat16, in the program's place, fails at
  least one limit; the program's readings of the same dispatch pass. (The
  dream's own control, the program with TF32 on, is the same as the
  program on the CPU: the card test below runs it.)"""
  lines = control.main(['--workload', cell, '--seeds', '3,4', '--seconds',
                        '0.05'], device='cpu', root=ROOT,
                       overrides={'config': tiny_config(cell),
                                  'traffic': TINY[cell]})
  for line in lines:
    lim = line['limits']
    assert all(line['program'][k] <= v for k, v in lim.items())
    bf16 = line.get('control_bf16', line['control'])
    assert any(bf16[k] > v for k, v in lim.items() if k in bf16)


@pytest.mark.cuda
def test_dream_tf32_control_fails_on_the_card(cuda_device):
  """The dream's control, the program run with TF32 on, fails a limit
  where the program's own run of the same seed passes them all."""
  line, = control.main(['--workload', 'dream.urchin-fbt', '--seeds',
                        '2147483671', '--seconds', '1'], root=ROOT)
  lim = line['limits']
  assert all(line['program'][k] <= v for k, v in lim.items())
  assert any(line['control'][k] > v for k, v in lim.items())


def test_barrel_decoder_equals_codec():
  from boxlcd_tpu_torch.data import native
  from portbench.drivers.mega_rollout import encode_barrels
  rng = np.random.default_rng(0)
  lcd = rng.random((2000, 6, 16, 32)) < 0.3
  traj = {'action': rng.random((2000, 6, 3), dtype=np.float32),
          'lcd': np.packbits(lcd, axis=-1),
          'proprio': rng.random((2000, 6, 5), dtype=np.float32)}
  bufs = encode_barrels(traj, 32, 1000, native)
  assert len(bufs) == 2
  for j, buf in enumerate(bufs):
    got = barrels.read(buf.getvalue())
    np.testing.assert_array_equal(got['lcd'], lcd[j * 1000:(j + 1) * 1000])
    np.testing.assert_array_equal(got['action'],
                                  traj['action'][j * 1000:(j + 1) * 1000])
    buf.seek(0)
    with np.load(buf) as z:
      np.testing.assert_array_equal(
          native.unpack_frames({'data': z['lcd_packed'],
                                'shape': z['lcd_shape']}), got['lcd'])


def test_sample_is_drawn_from_the_seed():
  a = check.sample(2 ** 31 + 5, 4000, 64)
  assert len(set(a)) == 64 and list(a) == sorted(a) and a.max() < 4000
  assert list(a) == list(check.sample(2 ** 31 + 5, 4000, 64))
  assert list(a) != list(check.sample(2 ** 31 + 6, 4000, 64))


# -- what a run may load, and where it may run ------------------------------

def test_forbidden_names_compare_whole():
  assert run.forbidden_modules({'boxlcd_tpu_torch', 'boxlcd_tpu_torch.data',
                                'jaxtyping', 'flaxen', 'numpy'}) == []
  assert run.forbidden_modules({'jax.numpy', 'boxlcd_tpu.engine', 'flax',
                                'jaxlib.xla_client'}) == \
      ['boxlcd_tpu', 'flax', 'jax', 'jaxlib']


def test_reference_imports_nothing_of_the_program():
  code = ('import sys; import portbench.reference.env, '
          'portbench.reference.episodes, portbench.reference.barrels, '
          'portbench.checks.mega_rollout, portbench.yardstick, '
          'portbench.metrics._read; '
          'bad = sorted({m.split(".")[0] for m in sys.modules} & '
          '{"boxlcd_tpu_torch", "boxlcd_tpu", "jax", "jaxlib", "flax"}); '
          'print(bad); sys.exit(1 if bad else 0)')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True)
  assert out.returncode == 0, out.stdout + out.stderr


def test_refuses_without_a_card(monkeypatch, capsys):
  """No fallback to the CPU: without a card the run exits non-zero and
  prints no result."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
  with pytest.raises(SystemExit) as e:
    run.main(['--workload', 'rollout.urchin-fast', '--seed', '1',
              '--seconds', '1', '--trace', '0'], root=ROOT)
  assert e.value.code not in (0, None)
  assert capsys.readouterr().out == ''


def test_refuses_in_a_bare_checkout(tmp_path):
  """In a directory holding only BENCHMARK.json and the benchmark's files,
  the program is missing: the run exits non-zero and prints no result."""
  import shutil
  shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
  shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  out = subprocess.run(
      [sys.executable, '-m', 'portbench.run', '--workload',
       'rollout.urchin-fast', '--seed', '1', '--seconds', '1', '--trace',
       '0'], cwd=tmp_path, capture_output=True, text=True, timeout=300)
  assert out.returncode != 0 and out.stdout.strip() == ''


@pytest.mark.cuda
@pytest.mark.parametrize('cell', COLLECTION)
def test_graph_replay_equals_eager_on_the_card(cuda_device, cell):
  """On the card the reference replays its plain substep as a CUDA graph:
  the same observations, bit for bit, as the eager plain step."""
  from portbench.reference import episodes
  _, cfg, traffic, _, _ = run.load_cell(ROOT, cell)
  w = check.world(cfg, traffic, cuda_device)
  g = torch.Generator(device=cuda_device).manual_seed(3)
  a, b = (episodes.replay(w, g.get_state(), cuda_device, 64, np.arange(8),
                          3, graph=graph) for graph in (True, False))
  for k in a:
    np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_cell_on_the_card(cuda_device, cell):
  """A short run of each cell on the card, in its own process, is correct
  and reports the card."""
  out = subprocess.run(
      [sys.executable, '-m', 'portbench.run', '--workload', cell, '--seed',
       '2147483659', '--seconds', '2', '--trace', '0'], cwd=ROOT,
      capture_output=True, text=True, timeout=900)
  assert out.returncode == 0, out.stderr[-4000:]
  line = json.loads(out.stdout.strip().splitlines()[-1])
  assert line['correct'] and line['device']['platform'] == 'gpu'
  assert line['device']['kind'] == torch.cuda.get_device_name(cuda_device)
