"""The port's `--mesh=dpN` (boxlcd_tpu_torch/parallel.py) on the CPU, where
a mesh's devices are N logical shards of the CPU:

- data-parallel training: the BVAE of tests/test_multichip.py:23-47
  (Dropbox, tiny_G, bs 8, 5 batches), port dp8 against port dp1 and
  against JAX dp8 on the conftest's 8 virtual devices, from the converted
  flax init and JAX's quantizer uniforms; that test's tolerances (loss
  rtol 1e-4; parameters rtol 2e-3, atol 2e-5): the loss at every step,
  the parameters after the first. (Later, float noise in the gradients,
  the shards' summation order or the two packages', reaches the parameters
  through Adam's normalised step where a gradient is tiny, ~1e-6, and
  through a quantizer code whose uniform sits within that noise of its
  probability: by step 5, 1-3 elements in 2,304 of a conv kernel read
  3.6e-5 to 6.0e-5 apart, port dp8 from dp1 as port from JAX.) Also
  VQVAE, whose perplexity is taken over the gathered batch;
- sharded collection: `fill_barrels` dp4 against dp1 and unsharded, every
  barrel field bit for bit;
- PPO's fused epochs: the real-env epoch dp4 against dp1 from the same fed
  normals (traj and last_v within 1e-6), and the learned-env epoch dp2
  against dp1 from one generator seed (every draw made at the whole
  batch's shape, so the same trajectory);
- JAX's assertions: a mesh that is not 'dp', a batch or num_envs that does
  not divide, more devices than the host has cards;
- `research.main --mode=train --mesh=dp8 --device=cpu` trains on 8 shards
  (it used to train unsharded), and the device-dataset trainer shards
  each step's batch (dp4 within 1e-5 of unsharded).
"""
import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch import parallel
from boxlcd_tpu_torch.data.collect import fill_barrels, make_rollout_fn
from boxlcd_tpu_torch.data.collect import write_barrel_file
from boxlcd_tpu_torch.data.dataset import RolloutDataset
from boxlcd_tpu_torch.research import main as research_main
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.autoencoders.vqvae import VQVAE
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.rl import main as tmain
from boxlcd_tpu_torch.research.rl.ppo import PPO
from boxlcd_tpu_torch.utils import AttrDict
from research.nets.autoencoders.bvae import BVAE as JBVAE
from tests.test_models import fake_batch, tiny_G

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

FAST = ['--vel_iters=2', '--pos_iters=1', '--device=cpu', '--log_n=100000']


class NullWriter:
  def add_scalar(self, *a, **k):
    pass

  add_image = add_video = add_scalar

  def flush(self):
    pass


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
  """A TensorBoard writer would import TensorFlow (~10 s here)."""
  monkeypatch.setattr(tutils, 'make_writer', lambda logdir: NullWriter())


def _feed(monkeypatch, queue):
  """parallel.rand hands out the arrays in `queue` (each at the whole
  batch's shape), through a shard's generator as through a plain one."""
  def rand(shape, gen, device):
    def make(s):
      u = queue.pop(0)
      assert tuple(u.shape) == tuple(s), (u.shape, s)
      return torch.as_tensor(u)
    if isinstance(gen, parallel.ShardGen):
      return gen.take('rand', shape, make, device)
    return make(tuple(shape)).to(device)
  monkeypatch.setattr(parallel, 'rand', rand)


def test_bvae_dp8_matches_dp1_and_jax_dp8(monkeypatch):
  jenv = boxlcd_tpu.env_map['Dropbox']()
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  jm = JBVAE(jenv, tiny_G(wh_ratio=jenv.G.wh_ratio,
                          lcd_base=jenv.G.lcd_base, bs=8, mesh='dp8'))
  assert jm.mesh.shape['dp'] == 8
  flax = jax.tree_util.tree_map(np.asarray, jm.params)
  ports = {}
  for mesh in ('dp8', 'dp1'):
    G = tconfig()
    G.update(hidden_size=32, nfilter=16, vqD=8, n_embed=32, n_head=2,
             n_layer=1, window=6, bs=8, lr=1e-3, vqK=16, device='cpu',
             wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base, mesh=mesh)
    ports[mesh] = BVAE(env, G)
    load_flax(ports[mesh].module, flax)
  assert ports['dp8'].mesh.n == 8 and len(ports['dp8']._replicas) == 8
  queue = []
  _feed(monkeypatch, queue)
  shape = (8 * 6, ports['dp8'].zH, ports['dp8'].zW, 8)

  def close(m):
    sd = ports[m].module.state_dict()
    jsd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jm.params))
    for k, v in jsd.items():
      np.testing.assert_allclose(sd[k].numpy(), v, rtol=2e-3, atol=2e-5,
                                 err_msg=f'{m} {k}')

  for i in range(5):
    batch = fake_batch(jenv, None, B=8, seed=i)
    # the uniforms JAX's next step draws: its loss key is the second half
    # of the next split of the model's key
    u = np.asarray(jax.random.uniform(jax.random.split(jm.key)[1], shape))
    jmet = jm.train_step(batch)
    nb = {k: np.asarray(v) for k, v in batch.items()}
    queue += [u, u]
    met = {m: ports[m].train_step(nb) for m in ports}
    assert not queue
    for m in ports:
      np.testing.assert_allclose(float(met[m]['loss/total']),
                                 float(jmet['loss/total']), rtol=1e-4)
    np.testing.assert_allclose(float(met['dp8']['loss/total']),
                               float(met['dp1']['loss/total']), rtol=1e-4)
    if i == 0:
      for m in ports:
        close(m)
      for k, v in ports['dp1'].module.state_dict().items():
        np.testing.assert_allclose(
            ports['dp8'].module.state_dict()[k].numpy(), v.numpy(),
            rtol=2e-3, atol=2e-5, err_msg=k)
  # a sharded forward first copies the master's weights to the replicas
  queue.append(u)
  ports['dp8'].train_step(nb, dry=True)
  for rep in ports['dp8']._replicas[1:]:
    for p, q in zip(ports['dp8'].module.parameters(),
                    rep.module.parameters()):
      assert torch.equal(p, q)


def test_vqvae_dp4_perplexity_over_the_whole_batch():
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  models = {}
  for mesh in ('dp4', ''):
    G = tconfig()
    G.update(hidden_size=32, nfilter=16, vqD=8, vqK=16, bs=8, lr=1e-3,
             device='cpu', wh_ratio=env.G.wh_ratio,
             lcd_base=env.G.lcd_base, mesh=mesh)
    models[mesh] = VQVAE(env, G)
  batch = {k: np.asarray(v) for k, v in fake_batch(
      boxlcd_tpu.env_map['Dropbox'](), None, B=8, seed=3).items()}
  for dry in (True, False):
    a = models['dp4'].train_step(batch, dry=dry)
    b = models[''].train_step(batch, dry=dry)
    assert set(a) == set(b)
    for k in b:
      np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5,
                                 err_msg=k)


def _barrels(folder):
  ds = RolloutDataset(folder, infinite=False)
  (f,) = sorted(folder.glob('*.barrel.npz'))
  return ds._load(f)


def test_fill_barrels_dp4_equals_dp1(tmp_path):
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': 3}, device='cpu')
  out = {}
  for mesh in ('dp4', 'dp1', ''):
    G = AttrDict(logdir=tmp_path / (mesh or 'none'), mesh=mesh)
    fill_barrels(env, 1, 'train', G, torch.Generator().manual_seed(5),
                 batch_size=1000)
    out[mesh] = _barrels(G.logdir / 'train')
  for mesh in ('dp4', 'dp1'):
    assert set(out[mesh]) == set(out[''])
    for k, v in out[''].items():
      assert np.array_equal(out[mesh][k], v), (mesh, k)
  assert out['']['lcd'].any() and not out['']['lcd'].all()


def _ppo(tmp_path, mesh, *extra):
  return PPO(tmain.parse([
      '--env=Urchin', '--num_envs=8', '--hidden_size=32', '--ep_len=3',
      *FAST, f'--logdir={tmp_path / (mesh or "none")}', f'--mesh={mesh}',
      *extra, 'ppo']))


def _close_traj(a, b, tol):
  for x, y in zip(a, b):
    if isinstance(x, dict):
      for k in x:
        np.testing.assert_allclose(x[k], y[k], atol=tol, rtol=0, err_msg=k)
    else:
      np.testing.assert_allclose(x, y, atol=tol, rtol=0)


def test_fused_real_epoch_dp4_equals_dp1(tmp_path):
  T = 7
  algos = {m: _ppo(tmp_path, m) for m in ('dp4', 'dp1')}
  eps = torch.randn((T, 8, algos['dp1'].act_space.shape[-1]),
                    generator=torch.Generator().manual_seed(3))
  out = {}
  for m, algo in algos.items():
    venv = algo.env
    venv.reset()
    out[m] = algo.rollout(venv.states, venv.goals, T, eps=eps)
  (s4, g4, t4, v4), (s1, g1, t1, v1) = out['dp4'], out['dp1']
  assert t4[5].any() and t4[5][2].all()          # timeouts at step 3
  _close_traj(t4, t1, 1e-6)
  np.testing.assert_allclose(v4, v1, atol=1e-6, rtol=0)
  assert v4.shape == (8,) and t4[1].shape[:2] == (T, 8)
  for f in s1._fields:
    assert torch.equal(getattr(s4, f), getattr(s1, f)), f
  for k in g1:
    assert torch.equal(g4[k], g1[k]), k


@pytest.fixture(scope='module')
def fbt_dir(tmp_path_factory):
  """An untrained tiny FBT over an untrained BVAE on Luxo 16x16."""
  root = tmp_path_factory.mktemp('fbt')
  env = boxlcd_tpu_torch.env_map['Luxo'](
      AttrDict(lcd_base=16, vel_iters=2, pos_iters=1), device='cpu')
  G = tconfig()
  G.update(env='Luxo', hidden_size=16, nfilter=8, vqK=16, vqD=4,
           n_embed=32, n_head=2, n_layer=1, window=6, lcd_base=16,
           wh_ratio=env.G.wh_ratio, vel_iters=2, pos_iters=1,
           device='cpu', weightdir=root)
  BVAE(env, G).save(root)
  FBT(env, G).save(root)
  return root


def test_fused_lenv_epoch_dp2_equals_dp1(tmp_path, fbt_dir):
  T = 6                                     # one lockstep timeout at 4
  out = {}
  for m in ('dp2', 'dp1'):
    algo = PPO(tmain.parse([
        '--env=Luxo', '--lcd_base=16', '--num_envs=4', '--hidden_size=32',
        '--ep_len=4', '--lenv=1', '--model=FBT', f'--weightdir={fbt_dir}',
        '--goal_thresh=0.3', *FAST, f'--logdir={tmp_path / m}',
        f'--mesh={m}', 'ppo']))
    algo.env.reset()
    lenv = algo.env.lenv
    algo._build_fused_lenv()
    assert len(algo._lenv_models) == int(m[2:])
    out[m] = algo.lenv_rollout(lenv.window_batch, lenv.ptr, lenv.ep_t,
                               dict(algo.env.goal), T)
  (wb2, p2, e2, g2, t2, v2), (wb1, p1, e1, g1, t1, v1) = (out['dp2'],
                                                          out['dp1'])
  assert (p2, e2) == (p1, e1) == (3, 2)
  assert t1[5][3].all()                          # the timeout
  _close_traj(t2, t1, 1e-6)
  np.testing.assert_allclose(v2, v1, atol=1e-6, rtol=0)
  for k in wb1:
    torch.testing.assert_close(wb2[k], wb1[k], atol=1e-6, rtol=0)
  for k in g1:
    assert torch.equal(g2[k], g1[k]), k


def test_jax_messages(tmp_path):
  with pytest.raises(AssertionError, match="unsupported mesh 'tp2'"):
    parallel.parse_mesh('tp2', 'cpu')
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': 2}, device='cpu')
  with pytest.raises(AssertionError,
                     match='collect batch 1000 must divide over 3 devices'):
    fill_barrels(env, 1, 'train', AttrDict(logdir=tmp_path, mesh='dp3'),
                 torch.Generator(), batch_size=1000)
  with pytest.raises(AssertionError,
                     match='num_envs 8 must divide over 3 devices'):
    _ppo(tmp_path, 'dp3')
  # on the card (no device='cpu'), never more shards than cards
  n = torch.cuda.device_count() + 1
  with pytest.raises(AssertionError,
                     match=f'mesh dp{n} needs {n} devices, have {n - 1}'):
    research_main.parse_flags(['--env=Dropbox', f'--mesh=dp{n}'])
  with pytest.raises(AssertionError, match=f'mesh dp{n} needs {n} devices'):
    tmain.main(['--env=Dropbox', f'--mesh=dp{n}', 'ppo'])
  with pytest.raises(AssertionError, match='must divide over 8 devices'):
    parallel.Mesh(['cpu'] * 8).check_divides(12, 'batch')
  with pytest.raises(ValueError, match='does not divide over 8 devices'):
    parallel.Mesh(['cpu'] * 8).shard(torch.zeros(12))


@pytest.fixture(scope='module')
def data(tmp_path_factory):
  """One train and one test native barrel of 8 Dropbox episodes."""
  root = tmp_path_factory.mktemp('data')
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': 6}, device='cpu')
  fn, T = make_rollout_fn(env, pack_lcd=True)
  traj = {k: v.numpy() for k, v in
          fn(torch.Generator().manual_seed(0), 16).items()}
  for i, sub in enumerate(('train', 'test')):
    (root / sub).mkdir()
    write_barrel_file(root / sub, i, T, env.lcd_w,
                      {k: v[8 * i:8 * (i + 1)] for k, v in traj.items()},
                      'native')
  return root


def test_main_train_mesh_dp8_trains_sharded(tmp_path, data, monkeypatch):
  """The regression test of the port's one open fault: --mesh=dp8 was
  ignored and the model trained unsharded."""
  calls = []
  sharded = BVAE._sharded_loss

  def counted(self, *a, **k):
    calls.append(self.mesh.n)
    return sharded(self, *a, **k)
  monkeypatch.setattr(BVAE, '_sharded_loss', counted)
  history = {}
  for mesh in ('dp8', ''):
    G, env = research_main.parse_flags([
        '--mode=train', '--model=BVAE', '--env=Dropbox', f'--datadir={data}',
        f'--logdir={tmp_path / (mesh or "none")}', '--bs=8', '--window=3',
        '--hidden_size=16', '--nfilter=8', '--vqK=16', '--vqD=4',
        '--total_itr=3', '--ep_len=6', f'--mesh={mesh}', *FAST,
        '--log_n=1'])
    model, history[mesh] = research_main.train(G, env)
    assert (model.mesh is None) == (not mesh)
  # 3 steps and 3 dry test batches, each over the 8 shards
  assert calls == [8] * 6 and len(history['']) == 3
  for (i, a), (j, b) in zip(history['dp8'], history['']):
    assert i == j
    for k in b:
      if not k.startswith('dt/'):           # the timers
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_train_device_dp4_equals_unsharded(data):
  from boxlcd_tpu_torch.data.device_dataset import DeviceDataset, train_device
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': 6}, device='cpu')
  ds = DeviceDataset(data / 'train', device='cpu')
  out = {}
  for mesh in ('dp4', ''):
    G = tconfig()
    G.update(hidden_size=16, nfilter=8, vqD=4, vqK=16, bs=8, lr=1e-3,
             device='cpu', wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base,
             mesh=mesh)
    model = BVAE(env, G)
    out[mesh] = train_device(model, ds, 4, bs=8, window=3, chunk=2,
                             matmul_precision='float32')
    assert model.step == 4
  for k, v in out[''].items():
    np.testing.assert_allclose(float(out['dp4'][k]), float(v), rtol=1e-5,
                               atol=1e-7, err_msg=k)
