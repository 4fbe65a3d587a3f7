"""The port's training path: the Trainer on port-written barrels, the
device-resident dataset (tests/test_data.py:69's packed-lcd check), the
checkpoint's save -> load -> resume (tests/test_resume.py:34 for the
port's `research.main`), the README's pipeline through the port's CLI,
collect -> BVAE -> FBT, and 2 training steps of each other video model,
on Dropbox at tiny widths on the CPU.
"""
import pickle

import numpy as np
import pytest
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.data.collect import make_rollout_fn, write_barrel_file
from boxlcd_tpu_torch.data.device_dataset import DeviceDataset, train_device
from boxlcd_tpu_torch.research import utils as rutils
from boxlcd_tpu_torch.research.define_config import config
from boxlcd_tpu_torch.research.main import main as tmain
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.runners.trainer import Trainer, load_arbiter

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TINY = ['--bs=8', '--log_n=1000', '--hidden_size=32', '--nfilter=8',
        '--vqK=16', '--vqD=8', '--n_embed=32', '--n_head=2', '--n_layer=1',
        '--device=cpu', '--env=Dropbox']


class RecordingWriter:
  """The writer's surface, keeping the tags it was given (a TensorBoard
  writer would import TensorFlow, ~10 s on this host)."""

  def __init__(self, *_):
    self.tags = []

  def add_scalar(self, tag, *a, **k):
    self.tags.append(tag)

  add_image = add_video = add_scalar

  def flush(self):
    pass


@pytest.fixture(autouse=True)
def writer(monkeypatch):
  w = RecordingWriter()
  monkeypatch.setattr(rutils, 'make_writer', lambda logdir: w)
  return w


@pytest.fixture(scope='module')
def data(tmp_path_factory):
  """Port-collected Dropbox episodes (per-step path, one rollout) as three
  barrels: train npz, train native, test native."""
  root = tmp_path_factory.mktemp('data')
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  fn, T = make_rollout_fn(env, pack_lcd=True)
  traj = {k: v.numpy() for k, v in
          fn(torch.Generator().manual_seed(0), 48).items()}
  for i, (sub, fmt) in enumerate([('train', 'npz'), ('train', 'native'),
                                  ('test', 'native')]):
    (root / sub).mkdir(exist_ok=True)
    write_barrel_file(root / sub, i, T, env.lcd_w,
                      {k: v[16 * i:16 * (i + 1)] for k, v in traj.items()},
                      fmt)
  return root


def _G(env, tmp_path, data, **kw):
  G = config()
  G.update(hidden_size=32, nfilter=8, vqD=8, vqK=16, n_embed=32, n_head=2,
           n_layer=1, window=5, bs=8, lr=1e-3, wh_ratio=env.G.wh_ratio,
           lcd_base=env.G.lcd_base, device='cpu', logdir=tmp_path,
           datadir=data, arbiterdir=tmp_path, total_itr=4, log_n=2,
           video_n=2, prompt_n=2)
  G.update(kw)
  return G


@pytest.mark.parametrize('model_name,resumed', [('BVAE', False),
                                                ('FBT', False),
                                                ('BVAE', True)])
def test_trainer_from_port_barrels(data, tmp_path, model_name, resumed,
                                   writer):
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  G = _G(env, tmp_path, data)
  if resumed:
    # a run cut at step 2 leaves its checkpoint; the next one resumes there
    cut = _G(env, tmp_path, data, total_itr=2)
    Trainer(BVAE(env, cut), env, cut).run()
  bvae = BVAE(env, G)
  model = bvae if model_name == 'BVAE' else FBT(env, G, bvae=bvae)
  if resumed:
    model.load(tmp_path)
    assert model.step == 2
  trainer = Trainer(model, env, G)
  assert trainer.train_ds.nbarrels == 2 and trainer.arbiter is None
  trainer.run()
  assert model.step == 4
  # logs at step 1 and every log_n steps; a resumed run starts at step 3
  assert [itr for itr, _ in trainer.history] == ([4] if resumed else
                                                 [1, 2, 4])
  with open(tmp_path / f'{model_name}.pkl', 'rb') as f:
    blob = pickle.load(f)
  assert blob['step'] == 4 and blob['G']['window'] == 5
  assert (tmp_path / 'hps.yaml').exists()
  # evaluate ran with the writer: the proprio re-render went through
  # Env.teleport + Env.observe
  assert {'eval/recon_proprio', 'eval/prompted_proprio'} & set(writer.tags)
  # evaluate: metrics of the prompted reconstructions / samples
  batch = next(iter(trainer.test_ds))
  metrics = model.evaluate(None, batch, 4)
  assert all(np.isfinite(v) for v in metrics.values()), metrics


def test_load_arbiter_raises_on_a_frozen_arbiter(tmp_path):
  """No frozen arbiter gives None; a torn one raises (the arbiters' own
  round trip is in tests/test_torch_arbiters.py)."""
  G = config()
  G.arbiterdir = tmp_path
  assert load_arbiter(G, None) is None
  (tmp_path / 'x.frozen.pkl').write_bytes(b'')
  with pytest.raises(EOFError):
    load_arbiter(G, None)


def test_save_load_resume_continues_identically(data, tmp_path):
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  G = _G(env, tmp_path, data)
  ds = DeviceDataset(data / 'train', device='cpu')
  a = BVAE(env, G)
  train_device(a, ds, 4, bs=8, window=5, chunk=2,
               matmul_precision='float32')
  a.save(tmp_path)
  b = BVAE(env, G)
  b.load(tmp_path)
  assert b.step == 4
  for k, v in a.module.state_dict().items():
    assert torch.equal(v, b.module.state_dict()[k]), k
  assert torch.equal(a.gen.get_state(), b.gen.get_state())
  # the same next steps from the same state
  ma = train_device(a, ds, 8, bs=8, window=5, chunk=2,
                    matmul_precision='float32')
  mb = train_device(b, ds, 8, bs=8, window=5, chunk=2,
                    matmul_precision='float32')
  for k in ma:
    assert torch.equal(ma[k], mb[k]), k
  # resume=False restores the weights only
  c = BVAE(env, G)
  c.load(tmp_path, resume=False)
  assert c.step == 0


def _step_of(pkl):
  with open(pkl, 'rb') as f:
    return int(pickle.load(f)['step'])


def test_main_device_train_resumes_from_checkpoint(data, tmp_path):
  """tests/test_resume.py:34 through the port's research.main."""
  def train(total_itr):
    tmain(['--mode=train', '--model=BVAE', f'--datadir={data}',
           f'--logdir={tmp_path}', f'--total_itr={total_itr}', '--window=5',
           '--device_dataset=1', '--steps_per_dispatch=4', *TINY])

  pkl = tmp_path / 'BVAE.pkl'
  train(8)
  assert _step_of(pkl) == 8
  with open(pkl, 'rb') as f:
    sd8 = pickle.load(f)['state_dict']
  train(16)  # resumes at 8 and trains 8 more
  assert _step_of(pkl) == 16
  with open(pkl, 'rb') as f:
    blob = pickle.load(f)
  assert any(not torch.equal(v, sd8[k]) for k, v in blob['state_dict'].items())
  assert {'opt_state', 'gen_state', 'G'} <= set(blob)
  train(16)  # nothing left to train: the checkpoint's step stays
  assert _step_of(pkl) == 16


@pytest.mark.parametrize('model', ['FIT', 'FRNLD', 'RSSM'])
def test_main_trains_video_models(data, tmp_path, model):
  """research.main --mode=train takes 2 steps of each video model beside
  FBT through the Trainer; FRNLD over an RNLDA trained 1 step into its
  weightdir."""
  args = [f'--datadir={data}', '--window=5', '--prompt_n=2', *TINY]
  if model == 'FRNLD':
    tmain(['--mode=train', '--model=RNLDA', f'--logdir={tmp_path / "r"}',
           '--total_itr=1', *args])
    args.append(f'--weightdir={tmp_path / "r"}')
  tmain(['--mode=train', f'--model={model}', f'--logdir={tmp_path / "m"}',
         '--total_itr=2', *args])
  assert _step_of(tmp_path / 'm' / f'{model}.pkl') == 2


def test_device_dataset_packed_lcd(data):
  """Bit-packed storage samples identically to byte storage
  (tests/test_data.py:69)."""
  packed = DeviceDataset(data / 'train', pack_lcd=True, device='cpu')
  plain = DeviceDataset(data / 'train', pack_lcd=False, device='cpu')
  assert packed.data['lcd'].shape[-1] * 8 == plain.data['lcd'].shape[-1]
  assert packed.n_episodes == 32
  bp = packed.sample(torch.Generator().manual_seed(1), 4, 3)
  bu = plain.sample(torch.Generator().manual_seed(1), 4, 3)
  for k in bp:
    assert bp[k].dtype == torch.float32 and torch.equal(bp[k], bu[k]), k


def test_main_collect_bvae_fbt(tmp_path):
  """collect -> --model=BVAE -> --model=FBT --weightdir=<bvae>, both
  device_dataset branches, through the port's CLI on the CPU."""
  data, bdir = tmp_path / 'data', tmp_path / 'bvae'
  tmain(['--mode=collect', f'--logdir={data}', '--train_barrels=1',
         '--test_barrels=1', '--num_envs=500', '--barrel_format=native',
         '--ep_len=10', *TINY])
  assert len(list((data / 'train').glob('*.tbarrel.npz'))) == 1
  tmain(['--mode=train', '--model=BVAE', f'--datadir={data}',
         f'--logdir={bdir}', '--total_itr=3', '--window=5', *TINY])
  assert _step_of(bdir / 'BVAE.pkl') == 3
  for dd in (0, 1):
    fdir = tmp_path / f'fbt{dd}'
    tmain(['--mode=train', '--model=FBT', f'--datadir={data}',
           f'--logdir={fdir}', f'--weightdir={bdir}', '--total_itr=2',
           '--window=6', f'--device_dataset={dd}', *TINY])
    assert _step_of(fdir / 'FBT.pkl') == 2
  # --mode=eval runs since the Evaler's port (tests/test_torch_eval.py),
  # --mode=viz since the Vizer's (tests/test_torch_viz_main.py): over the
  # device-dataset FBT, one gif a rollout
  tmain(['--mode=viz', '--model=FBT', f'--weightdir={tmp_path / "fbt1"}',
         f'--logdir={tmp_path / "viz"}', *TINY])
  assert len(list((tmp_path / 'viz').glob('viz_rollout_*.gif'))) == 4
