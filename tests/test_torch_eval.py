"""The port's evaluation chain against the JAX package's: `chop` and the
arbiter features, both `evaluate`s' arbiter branches, the empty chop, the
Evaler's logger.pkl, and `--mode=train --model=MultiStepArbiter` then
`--mode=eval` through the port's CLI.

Both packages run the same arbiter parameters (a JAX MultiStepArbiter or
ArbiterAE at tiny widths, each package's own frozen file: the JAX one's
flax bytes, the port's state dict converted from them) on the same
numpy-made inputs. Where the JAX code draws noise (random actions, prior
samples) the test hands both packages the same numpy arrays: a stub
`sample`, `jax.random.uniform` patched for the JAX side and
`video_models._base.uniform_actions` for the port, inside the test only.
Streams are never compared. Tolerance: features and metrics within 1e-5
relative (FID and precision/recall run on float32 features that agree to
~1e-6).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research import metrics as M
from boxlcd_tpu_torch.research import utils as rutils
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.main import main as tmain
from boxlcd_tpu_torch.research.nets.autoencoders import (
    BVAE, ArbiterAE, MultiStepArbiter)
from boxlcd_tpu_torch.research.nets.convert import load_flax
from boxlcd_tpu_torch.research.nets.video_models import _base as vm
from boxlcd_tpu_torch.research.runners.evaler import Evaler
from boxlcd_tpu_torch.research.runners.trainer import load_arbiter
from research import metrics as JM
from research.define_config import config as jconfig
from research.nets.autoencoders.arbiter import ArbiterAE as JArbiterAE
from research.nets.autoencoders.bvae import BVAE as JBVAE
from research.nets.autoencoders.multistep_arbiter import (
    MultiStepArbiter as JMultiStepArbiter)
from research.nets.video_models import _base as jvm
from research.runners.evaler import Evaler as JEvaler
from research.runners.trainer import load_arbiter as jload_arbiter
from tests.test_torch_train import RecordingWriter

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

RTOL = 1e-5
ENV = 'Urchin'                     # 16x32 frames, proprio: not passive
WIDTHS = dict(hidden_size=32, nfilter=8, vqD=8, vqK=16, n_embed=32,
              n_head=2, n_layer=1, bs=8, lr=1e-3)


def tiny_G(config, env, **kw):
  G = config()
  G.update(WIDTHS, wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base, **kw)
  return G


def fixed(shape, seed, kind='uniform'):
  r = np.random.RandomState(seed)
  if kind == 'bits':
    return (r.rand(*shape) > 0.5).astype(np.float32)
  if kind == 'normal':
    return r.standard_normal(shape).astype(np.float32)
  return r.uniform(-1, 1, shape).astype(np.float32)


def episodes(env, n, T, seed):
  return {'lcd': fixed((n, T, env.lcd_h, env.lcd_w), seed, 'bits'),
          'proprio': fixed((n, T, env.pobs_size), seed + 1),
          'action': fixed((n, T, env.act_size), seed + 2),
          'full_state': fixed((n, T, env.obs_size), seed + 3)}


def close(ours, ref, rtol=RTOL):
  a = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) \
      else np.asarray(ours)
  np.testing.assert_allclose(a, np.asarray(ref), rtol=rtol, atol=1e-6)


def same_metrics(ours, ref):
  assert set(ours) == set(ref), (sorted(ours), sorted(ref))
  for k in ref:
    close(np.asarray(ours[k], np.float64), np.asarray(ref[k], np.float64))


@pytest.fixture(scope='module')
def envs():
  return boxlcd_tpu.env_map[ENV](), \
      boxlcd_tpu_torch.env_map[ENV](device='cpu')


def frozen_pair(envs, tmp_path, kind, **kw):
  """(JAX arbiter dict, port arbiter dict): one JAX arbiter's parameters,
  each package's frozen file in its own folder, each package's
  load_arbiter."""
  jenv, env = envs
  jcls, tcls = {'MultiStepArbiter': (JMultiStepArbiter, MultiStepArbiter),
                'ArbiterAE': (JArbiterAE, ArbiterAE)}[kind]
  jarb = jcls(jenv, tiny_G(jconfig, jenv, **kw))
  tarb = tcls(env, tiny_G(tconfig, env, device='cpu', **kw))
  load_flax(tarb.module, jax.tree_util.tree_map(np.asarray, jarb.params))
  jarb.save_frozen(tmp_path / 'jax')
  tarb.save_frozen(tmp_path / 'port')
  out = []
  for load, sub, config in ((jload_arbiter, 'jax', jconfig),
                            (load_arbiter, 'port', tconfig)):
    G = config()
    G.arbiterdir = tmp_path / sub
    out.append(load(G, envs[0] if sub == 'jax' else env))
  return out


class JStub(jvm.VideoModel):
  """A deterministic `sample`: fixed frames unprompted; prompted, the prompt
  then the truth one frame late, frames inverted and proprio halved."""

  def sample(self, key, n, action=None, prompts=None, prompt_n=10,
             temp=1.0):
    if prompts is None:
      T, H, W = self.block_size, self.env.lcd_h, self.env.lcd_w
      return {'lcd': jnp.asarray(fixed((n, T, H, W), 5, 'bits')),
              'proprio': jnp.asarray(fixed((n, T, self.proprio_n), 6,
                                           'normal'))}
    lcd, pro = prompts['lcd'], prompts['proprio']
    return {'lcd': jnp.concatenate([lcd[:, :prompt_n],
                                    1 - lcd[:, prompt_n - 1:-1]], 1),
            'proprio': jnp.concatenate([pro[:, :prompt_n],
                                        0.5 * pro[:, prompt_n - 1:-1]], 1)}


class TStub(vm.VideoModel):
  """JStub's `sample` in torch."""

  def sample(self, gen, n, action=None, prompts=None, prompt_n=10,
             temp=1.0):
    if prompts is None:
      T, H, W = self.block_size, self.env.lcd_h, self.env.lcd_w
      return {'lcd': torch.as_tensor(fixed((n, T, H, W), 5, 'bits')),
              'proprio': torch.as_tensor(fixed((n, T, self.proprio_n), 6,
                                               'normal'))}
    lcd, pro = prompts['lcd'], prompts['proprio']
    return {'lcd': torch.cat([lcd[:, :prompt_n],
                              1 - lcd[:, prompt_n - 1:-1]], 1),
            'proprio': torch.cat([pro[:, :prompt_n],
                                  0.5 * pro[:, prompt_n - 1:-1]], 1)}


@pytest.fixture
def fixed_actions(monkeypatch):
  """The random actions of both packages' unprompted samples, as one
  numpy draw per shape."""
  monkeypatch.setattr(jax.random, 'uniform', lambda key, shape, minval=0.,
                      maxval=1.: jnp.asarray(fixed(shape, 9)))
  monkeypatch.setattr(vm, 'uniform_actions', lambda gen, shape, device:
                      torch.as_tensor(fixed(shape, 9)))


def test_chop_and_arbiter_feats(envs, tmp_path):
  jarb, tarb = frozen_pair(envs, tmp_path, 'MultiStepArbiter', window=3)
  assert tarb['window'] == jarb['window'] == 3
  clips = episodes(envs[1], 4, 8, 0)
  for w in (3, 4, 8):   # a remainder of 2, none, one window
    for k, v in clips.items():
      assert np.array_equal(vm.chop(torch.as_tensor(v), w).numpy(),
                            np.asarray(jvm.chop(jnp.asarray(v), w))), (k, w)
  tb = {k: torch.as_tensor(v) for k, v in clips.items()}
  with torch.no_grad():
    z, almse = vm.arbiter_feats(tarb, tb, tb['action'])
  jz, jalmse = jvm.VideoModel._arbiter_feats(None, jarb, clips,
                                             clips['action'])
  assert z.shape == (8, 256)
  close(z, jz)
  close(almse, jalmse)


def test_empty_chop_behaves_as_in_jax(envs, tmp_path):
  """At kicker.py's settings (window 50, prompt 3) a burned clip of 47
  frames chops into no window: the arbiter's forward then raises in both
  packages (its reshape of a 0-clip batch), FID of no features is nan and
  precision/recall raises (top-k of an empty set)."""
  x = fixed((4, 47, 16, 32), 0, 'bits')
  assert vm.chop(torch.as_tensor(x), 50).shape == \
      jvm.chop(jnp.asarray(x), 50).shape == (0, 50, 16, 32)
  jarb, tarb = frozen_pair(envs, tmp_path, 'MultiStepArbiter', window=3)
  short = episodes(envs[1], 4, 2, 1)          # 2 frames, window 3
  with pytest.raises(ZeroDivisionError):
    jvm.VideoModel._arbiter_feats(None, jarb, short, short['action'])
  with pytest.raises(RuntimeError, match='0 elements'), torch.no_grad():
    vm.arbiter_feats(tarb, {k: torch.as_tensor(v) for k, v in short.items()},
                     torch.as_tensor(short['action']))
  none, some = np.zeros((0, 256), np.float32), fixed((64, 256), 2, 'normal')
  with np.errstate(all='ignore'), pytest.warns(RuntimeWarning):
    assert np.isnan(M.fid(none, some)) and np.isnan(JM.fid(none, some))
  with pytest.raises(ValueError, match='top_k'):
    JM.precision_recall_f1(some, none)
  with pytest.raises(RuntimeError, match='out of range'):
    M.precision_recall_f1(torch.as_tensor(some), torch.as_tensor(none))


def test_video_evaluate_with_a_multistep_arbiter(envs, tmp_path,
                                                 fixed_actions):
  jenv, env = envs
  jarb, tarb = frozen_pair(envs, tmp_path, 'MultiStepArbiter', window=3)
  kw = dict(window=8, prompt_n=2, video_n=8)
  jm = JStub(jenv, tiny_G(jconfig, jenv, **kw))
  tm = TStub(env, tiny_G(tconfig, env, device='cpu', **kw))
  batch = episodes(env, 8, 8, 3)
  ours = tm.evaluate(None, batch, 1, arbiter=tarb)
  ref = jm.evaluate(None, {k: jnp.asarray(v) for k, v in batch.items()}, 1,
                    arbiter=jarb)
  assert {'eval/unprompted_fvd', 'eval/unprompted_precision',
          'eval/unprompted_action_log_mse', 'eval/prompted_cosdist',
          'eval/prompted_true_action_log_mse'} <= set(ref)
  same_metrics(ours, ref)


def test_autoencoder_evaluate_with_an_arbiter_ae(envs, tmp_path):
  """BVAE recon metrics, the FID of prior samples and the feature cosdist;
  the prior's z is one numpy draw in both packages. A MultiStepArbiter is
  ignored by both."""
  jenv, env = envs
  jarb, tarb = frozen_pair(envs, tmp_path / 'ae', 'ArbiterAE', window=5)
  jm = JBVAE(jenv, tiny_G(jconfig, jenv, window=5))
  tm = BVAE(env, tiny_G(tconfig, env, device='cpu', window=5))
  load_flax(tm.module, jax.tree_util.tree_map(np.asarray, jm.params))
  z = fixed((40, tm.zH, tm.zW, tm.G.vqD), 4, 'bits')
  jm.sample_z = lambda key, n: jnp.asarray(z[:n])
  tm.sample_z = lambda gen, n: torch.as_tensor(z[:n])
  batch = episodes(env, 8, 5, 5)
  ours = tm.evaluate(None, batch, 1, arbiter=tarb)
  ref = jm.evaluate(None, {k: jnp.asarray(v) for k, v in batch.items()}, 1,
                    arbiter=jarb)
  assert {'eval/fid', 'eval/cosdist'} <= set(ref)
  same_metrics(ours, ref)
  jms, tms = frozen_pair(envs, tmp_path / 'ms', 'MultiStepArbiter', window=5)
  assert set(tm.evaluate(None, batch, 1, arbiter=tms)) == \
      set(jm.evaluate(None, batch, 1, arbiter=jms)) == set(ref) - {
          'eval/fid', 'eval/cosdist'}


@pytest.fixture(scope='module')
def barrels(tmp_path_factory, envs):
  """One numpy-made Urchin barrel each for train and test (16 episodes x
  10 frames), in the npz layout both packages read."""
  root = tmp_path_factory.mktemp('barrels')
  for i, sub in enumerate(('train', 'test')):
    (root / sub).mkdir()
    ep = episodes(envs[1], 16, 10, 10 * i)
    ep['lcd'] = ep['lcd'].astype(bool)
    np.savez_compressed(root / sub / f'x-{i:05d}-10.barrel', **ep)
  return root


def test_evaler_matches_jax(envs, barrels, tmp_path, fixed_actions):
  """The same barrels, stub model and arbiter parameters: the JAX Evaler's
  logger.pkl keys, values within 1e-5 relative."""
  jenv, env = envs
  jarb, _ = frozen_pair(envs, tmp_path / 'arb', 'MultiStepArbiter',
                        window=2)
  kw = dict(window=6, prompt_n=2, eval_n=16, datadir=barrels)
  jG = tiny_G(jconfig, jenv, logdir=tmp_path / 'jax',
              arbiterdir=tmp_path / 'arb' / 'jax', **kw)
  tG = tiny_G(tconfig, env, device='cpu', logdir=tmp_path / 'port',
              arbiterdir=tmp_path / 'arb' / 'port', **kw)
  ref = JEvaler(JStub(jenv, jG), jenv, jG).run(reps=2)
  ours = Evaler(TStub(env, tG), env, tG).run(reps=2)
  assert jarb['window'] == 2
  for split in ('test', 'train'):
    for key in ('u:fvd', 'p:fvd', 'p:ssim', 'p:psnr', 'p:cosdist',
                'p:precision', 'p:recall', 'p:f1', 'p:proprio_log_mse',
                'p:action_log_mse', 'p:true_action_log_mse',
                'u:action_log_mse', 'u:precision'):
      assert f'{split}:{key}' in ref
  assert set(ours) == set(ref)
  for k in ref:
    close(np.asarray(ours[k]), np.asarray(ref[k]))
  with open(tmp_path / 'port' / 'logger.pkl', 'rb') as f:
    assert pickle.load(f) == ours


def test_main_train_multistep_arbiter_then_eval(barrels, tmp_path,
                                                monkeypatch):
  """BVAE -> FBT -> MultiStepArbiter -> --mode=eval through the port's
  research.main on the CPU."""
  monkeypatch.setattr(rutils, 'make_writer', lambda logdir: RecordingWriter())
  tiny = ['--env=Urchin', '--device=cpu', '--bs=8', '--hidden_size=32',
          '--nfilter=8', '--vqK=16', '--vqD=8', '--n_embed=32', '--n_head=2',
          '--n_layer=1', '--log_n=2', '--total_itr=2', f'--datadir={barrels}']
  bdir, fdir, adir, edir = (tmp_path / d for d in ('b', 'f', 'a', 'e'))
  tmain(['--mode=train', '--model=BVAE', f'--logdir={bdir}', '--window=5',
         *tiny])
  tmain(['--mode=train', '--model=FBT', f'--logdir={fdir}',
         f'--weightdir={bdir}', '--window=6', '--prompt_n=2', *tiny])
  tmain(['--mode=train', '--model=MultiStepArbiter', f'--logdir={adir}',
         '--window=3', *tiny])
  assert {p.name for p in adir.glob('*.pkl')} == {
      'MultiStepArbiter.pkl', 'MultiStepArbiter.frozen.pkl'}
  tmain(['--mode=eval', '--model=FBT', f'--weightdir={fdir}',
         f'--arbiterdir={adir}', f'--logdir={edir}', '--eval_n=16', *tiny])
  with open(edir / 'logger.pkl', 'rb') as f:
    final = pickle.load(f)
  keys = {k.split(':', 1)[1] for k in final}
  assert keys == {'u:action_log_mse', 'u:fvd', 'u:precision', 'u:recall',
                  'u:f1', 'p:ssim', 'p:psnr', 'p:proprio_log_mse',
                  'p:action_log_mse', 'p:true_action_log_mse', 'p:cosdist',
                  'p:fvd', 'p:precision', 'p:recall', 'p:f1'}
  assert {k.split(':', 1)[0] for k in final} == {'test', 'train'}
  assert all(np.isfinite(v).all() for v in final.values()), final
