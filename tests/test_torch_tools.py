"""The port's research tools against the JAX package's, on the CPU: kicker's
commands, metrics_table's LaTeX rows, rl_curves' scalar loading, the chain
scripts' command sequences (headline_rl, model_table), bench_bisect's
stages, and the Trainer's profile and chunked steps (G.profile,
G.steps_per_dispatch).
"""
import json
import sys

import numpy as np
import pytest
import torch

from boxlcd_tpu_torch import bench
from boxlcd_tpu_torch.data.collect import make_rollout_fn, write_barrel_file
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research import main as tresearch
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.rl import main as trl
from boxlcd_tpu_torch.research.runners import evaler as tevaler
from boxlcd_tpu_torch.research.runners.trainer import Trainer
from boxlcd_tpu_torch.research.scripts import (
    bench_bisect, headline_rl, kicker)
from boxlcd_tpu_torch.research.scripts import metrics_table, model_table
from boxlcd_tpu_torch.research.scripts import rl_curves
from boxlcd_tpu_torch.utils import AttrDict
import boxlcd_tpu_torch
from research import utils as jutils
from research.runners.trainer import Trainer as JTrainer
from research.scripts import kicker as jkicker
from research.scripts import metrics_table as jmetrics_table
from research.scripts import rl_curves as jrl_curves

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


def _jax_main(monkeypatch, capsys, module, argv):
  """Run a JAX script's argparse main with sys.argv; its stdout lines."""
  monkeypatch.setattr(sys, 'argv', [module.__name__, *argv])
  capsys.readouterr()
  module.main()
  return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize('argv', [
    ['--model=BVAE', '--envs=0'],
    ['--model=FBT', '--envs=1', '--weightdir=w', '--arbiterdir=a',
     '--extra=--total_itr=100 --log_n=50'],
    ['--model=FIT', '--envs=Dropbox', '--bs=8', '--lr=1e-3'],
], ids=['bvae-tier0', 'fbt-tier1-dirs-extra', 'fit-dropbox'])
def test_kicker_dry_commands_equal_jax(monkeypatch, capsys, argv):
  want = _jax_main(monkeypatch, capsys, jkicker, [*argv, '--dry'])
  kicker.main([*argv, '--dry'])
  got = capsys.readouterr().out.splitlines()
  assert got == [w.replace('-m research.main', f'-m {kicker.MODULE}')
                 for w in want]
  assert len(got) == len(kicker.ENVS.get(
      argv[1].split('=')[1], [argv[1].split('=')[1]]))


def test_kicker_models_list_is_all_model_tests_loop(monkeypatch, capsys):
  """--models=A,B runs research/scripts/all_model_test.sh's loop: each
  model's sweep in turn, the JAX commands one model at a time."""
  models = ['BVAE', 'RNLDA', 'VAE', 'RSSM', 'FIT']
  want = []
  for m in models:
    want += _jax_main(monkeypatch, capsys, jkicker,
                      [f'--model={m}', '--envs=0', '--dry'])
  kicker.main([f'--models={",".join(models)}', '--envs=0', '--dry'])
  got = capsys.readouterr().out.splitlines()
  assert got == [w.replace('-m research.main', f'-m {kicker.MODULE}')
                 for w in want]


def _evaler_table(tmp_path, model, env, values):
  """logger.pkl written by the port's Evaler.run (its per-rep metrics
  stubbed) at <tmp>/<model>/<env>."""
  ev = object.__new__(tevaler.Evaler)
  ev.G = AttrDict(logdir=tmp_path / model / env)
  ev.model = AttrDict(device=torch.device('cpu'))
  ev.train_ds = ev.test_ds = None
  ev.rep_s = []
  # both splits of a rep read that rep's values
  ev.do_ds = lambda ds, gen: values[len(ev.rep_s)]
  return ev.run(reps=len(values))


def test_metrics_table_prints_jax_text(tmp_path, monkeypatch, capsys):
  rng = np.random.default_rng(0)
  for model in ('FBT', 'RSSM'):
    for env in ('Urchin', 'Luxo'):
      if (model, env) == ('RSSM', 'Luxo'):
        continue        # a missing pickle gives a row of dashes
      metrics = ['fvd', 'ssim', 'psnr'] + (['cosdist'] if model == 'FBT'
                                           else [])
      vals = [{f'{m}:{k}': float(rng.uniform(0, 50)) for m in ('u', 'p')
               for k in metrics} for _ in range(4)]
      table = _evaler_table(tmp_path, model, env, vals)
      assert set(table) >= {f'test:p:{k}' for k in metrics}
  argv = [f'--logdir={tmp_path}', '--models=FBT,RSSM,FIT',
          '--envs=Urchin,Luxo']
  want = _jax_main(monkeypatch, capsys, jmetrics_table, argv)
  got = metrics_table.main(argv)
  capsys.readouterr()
  assert got.splitlines() == want
  assert '$\\pm$' in got and '--' in got.splitlines()[2]


def test_rl_curves_load_scalars_events_and_csv(tmp_path):
  tag = 'test/success_rate'
  pairs = [(0, 0.0), (128, 0.25), (256, 0.5)]
  ev = tmp_path / 'events'
  w = tutils.make_writer(ev)              # tensorboard is on this host
  for step, v in pairs:
    w.add_scalar(tag, v, step)
  w.flush()
  got = rl_curves.load_scalars(ev, tag)
  assert got == jrl_curves.load_scalars(ev, tag)
  assert [s for s, _ in got] == [s for s, _ in pairs]
  assert np.allclose([v for _, v in got], [v for _, v in pairs])
  csv = tmp_path / 'csv'
  csv.mkdir()
  (csv / 'test_success_rate.csv').write_text(
      'step,value\n' + ''.join(f'{s},{v}\n' for s, v in pairs))
  assert rl_curves.load_scalars(csv, tag) == \
      jrl_curves.load_scalars(csv, tag) == pairs
  assert rl_curves.load_scalars(tmp_path / 'none', tag) == []
  out = tmp_path / 'curves.png'
  assert rl_curves.main(['--runs', f'events={ev}', f'csv={csv}',
                         f'--out={out}']) == str(out) and out.exists()


def _parse(cmd):
  """Parse one chain command through the port's own parser."""
  mod, argv = cmd[2], cmd[3:]
  if mod == headline_rl.MAIN:
    G, env = tresearch.parse_flags(argv)
    return G
  if mod in (headline_rl.RL, headline_rl.EVAL):
    return trl.parse(argv)
  assert mod == model_table.TABLE
  return metrics_table.main(argv)


def test_chain_dry_sequences_parse(tmp_path, capsys):
  cmds = headline_rl.main(['Luxo', str(tmp_path / 'hl'), '12000', '--dry',
                           '--device=cpu'])
  out = capsys.readouterr().out
  assert out.count('=== ') == 8 and len(cmds) == 7
  assert 'retry' not in out
  Gs = [_parse(c) for c in cmds]
  assert Gs[0].mode == 'collect' and Gs[0].train_barrels == 100
  assert Gs[1].model == 'BVAE' and Gs[1].total_itr == 30000
  assert Gs[2].model == 'FBT' and Gs[2].n_embed == 512
  assert Gs[3].algo == 'ppo' and Gs[3].lenv == 0 and \
      Gs[3].total_steps == 12000 and Gs[3].num_envs == 128
  assert Gs[5].lenv == 1 and Gs[5].model == 'FBT' and \
      Gs[5].weightdir == tmp_path / 'hl' / 'fbt'
  assert str(Gs[4].logdir).endswith('ppo_real')
  assert all(G.device == 'cpu' for G in Gs)
  cmds = model_table.main(['Dropbox Urchin', str(tmp_path / 'mt'), '7',
                           '5', '--dry', '--device=cpu'])
  table = _parse(cmds[-1])
  assert len(table.splitlines()) == 3 and table.count('--') == 32
  capsys.readouterr()
  Gs = [_parse(c) for c in cmds[:-1]]
  assert len(cmds) == 2 * (4 + 2 * 4) + 1
  train = [G for G in Gs if G.mode == 'train']
  assert all(G.device == 'cpu' for G in Gs)
  assert {(G.env, G.model) for G in train if G.total_itr == 7} == {
      (e, m) for e in ('Dropbox', 'Urchin') for m in model_table.MODELS}
  assert {G.window for G in train if G.env == 'Dropbox'
          and G.total_itr == 7} == {25}
  evals = [G for G in Gs if G.mode == 'eval']
  assert len(evals) == 8 and all(G.bs == 256 for G in evals)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
  """Port-collected Dropbox episodes as a train and a test native barrel."""
  root = tmp_path_factory.mktemp('data')
  env = boxlcd_tpu_torch.env_map['Dropbox'](
      {'vel_iters': 2, 'pos_iters': 1, 'ep_len': 8}, device='cpu')
  fn, T = make_rollout_fn(env, pack_lcd=True)
  traj = {k: v.numpy() for k, v in
          fn(torch.Generator().manual_seed(0), 32).items()}
  for i, sub in enumerate(('train', 'test')):
    (root / sub).mkdir()
    write_barrel_file(root / sub, i, T, env.lcd_w,
                      {k: v[16 * i:16 * (i + 1)] for k, v in traj.items()},
                      'native')
  return root


def test_profile_writes_a_trace(data, tmp_path, monkeypatch):
  """--profile=1 traces the first min(50, total_itr) steps into a Chrome
  trace in the logdir (CPU activity here) instead of raising."""
  monkeypatch.setattr(tutils, 'make_writer',
                      lambda logdir: tutils.NullWriter())
  logdir = tmp_path / 'run'
  tresearch.main(['--mode=train', '--model=BVAE', f'--datadir={data}',
                  f'--logdir={logdir}', '--total_itr=3', '--window=4',
                  '--profile=1', '--bs=4', '--log_n=2', '--hidden_size=16',
                  '--nfilter=4', '--vqK=8', '--vqD=4', '--device=cpu',
                  '--env=Dropbox', '--vel_iters=2', '--pos_iters=1',
                  '--ep_len=8'])
  traces = sorted(logdir.glob('trace_*.json'))
  assert [t.name for t in traces] == ['trace_3.json']
  events = json.loads(traces[0].read_text())['traceEvents']
  names = {e.get('name', '') for e in events}
  assert any(n.startswith('aten::') for n in names), sorted(names)[:20]


class _Stub:
  """A model whose steps record the batches they consume."""

  def __init__(self):
    self.step, self.seen, self.evals, self.saves = 0, [], [], 0

  def train_step(self, batch, dry=False):
    if dry:
      return {'loss': -float(batch['id'])}
    self.seen.append(int(batch['id']))
    self.step += 1
    return {'loss': float(batch['id'])}

  def train_steps(self, batches):
    ids = np.asarray(batches['id'])
    self.seen += [int(i) for i in ids]
    self.step += len(ids)
    return {'loss': float(ids[-1])}

  def evaluate(self, writer, batch, itr, arbiter=None):
    self.evals.append(itr)
    return {}

  def save(self, logdir):
    self.saves += 1


class _Writer:
  def __init__(self):
    self.rows = []

  def add_scalar(self, tag, value, itr):
    if not tag.startswith('dt/'):
      self.rows.append((tag, round(float(value), 6), int(itr)))

  def flush(self):
    pass


def _run_trainer(cls, logger, b, tmp_path, K, total, log_n):
  tr = object.__new__(cls)
  tr.model, tr.env, tr.writer = _Stub(), None, _Writer()
  tr.G = AttrDict(total_itr=total, log_n=log_n, save_n=1000, profile=0,
                  steps_per_dispatch=K, logdir=tmp_path)
  tr.train_ds = [{'id': np.float32(i)} for i in range(100)]
  tr.test_ds = [{'id': np.float32(1000 + i)} for i in range(100)]
  tr.logger, tr.arbiter, tr.history = logger, None, []
  tr.b = b
  tr.run()
  return tr


@pytest.mark.parametrize('K,total,log_n', [(1, 7, 3), (3, 10, 4), (4, 13, 5)])
def test_trainer_chunk_steps_and_log_points_equal_jax(tmp_path, K, total,
                                                      log_n):
  """With steps_per_dispatch = K the port's Trainer takes JAX's steps
  (the same batches, K a round) and logs at JAX's points with JAX's
  values."""
  import jax.numpy as jnp
  jt = _run_trainer(JTrainer, jutils.AutoLogger(),
                    lambda bt: {k: jnp.asarray(v) for k, v in bt.items()},
                    tmp_path / 'jax', K, total, log_n)
  tt = _run_trainer(Trainer, tutils.AutoLogger(), None, tmp_path / 'port',
                    K, total, log_n)
  assert tt.model.seen == jt.model.seen
  assert tt.model.evals == jt.model.evals and tt.model.evals
  assert tt.writer.rows == jt.writer.rows
  assert [itr for itr, _ in tt.history] == tt.model.evals


def test_rl_curves_without_matplotlib_raises(tmp_path, monkeypatch):
  monkeypatch.setitem(sys.modules, 'matplotlib', None)   # import fails
  with pytest.raises(RuntimeError, match='matplotlib'):
    rl_curves.main(['--runs', f'x={tmp_path}', f'--out={tmp_path / "a.png"}'])


@pytest.mark.parametrize('tool,argv', [
    ('bench_bisect', []), ('roofline', []), ('exit_probe', []),
    ('benchmark_e2e', ['--workdir=/nonexistent/e2e']),
    ('model_probe', ['ppo', '--weightdir=/nonexistent']),
])
def test_tools_raise_without_a_card(tool, argv):
  """Entry points run on the card unless asked for the CPU: here, with no
  card, they raise before any work (no fallback)."""
  import importlib
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  mod = importlib.import_module(
      f'boxlcd_tpu_torch.research.scripts.{tool}')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    mod.main(argv)


def test_bench_bisect_stages_on_cpu():
  """Every stage runs on the CPU (the kernels' plain versions) at B = 8,
  T = 2; +full_state consumes what the port bench's mega chunk does."""
  out = bench_bisect.run('Urchin', 8, 2, device='cpu')
  assert list(out) == list(bench_bisect.STAGES)
  assert all(r['ms'] > 0 and r['launches'] == {
      'mega_rollout': 0, 'traj_raster': 0, 'lcd_raster': 0}
      for r in out.values())
  env = boxlcd_tpu_torch.env_map['Urchin']({'vel_iters': 8, 'pos_iters': 4},
                                           device='cpu')
  gen = torch.Generator().manual_seed(0)
  st = Env.reset(env, gen, 8)
  acts = torch.rand((2, 8, env.act_size), generator=gen) * 2 - 1
  ms = physics.motor_speeds(env.spec, acts).contiguous()
  stages = bench_bisect.make_stages(env, 2)
  want = bench.make_chunk(env, 'mega', 2)(st, acts)[1]
  assert torch.equal(stages['+full_state'](st, ms), want)
  assert torch.isfinite(stages['full(old)'](st, ms))


def test_write_image_png_and_npz_fallback(tmp_path, monkeypatch):
  """fit_diag's strip: a PNG with Pillow, the image as .npz without."""
  img = np.random.default_rng(0).random((8, 12, 3))
  assert tutils.write_image(tmp_path / 'a.png', img) == str(tmp_path /
                                                             'a.png')
  from PIL import Image
  got = np.asarray(Image.open(tmp_path / 'a.png'))
  want = (255 * img.astype(np.float32)).astype(np.uint8)
  assert np.array_equal(got, want)
  monkeypatch.setitem(sys.modules, 'PIL', None)
  path = tutils.write_image(tmp_path / 'b.png', img)
  assert path == str(tmp_path / 'b.png') + '.npz'
  assert np.array_equal(np.load(path)['image'], want)
