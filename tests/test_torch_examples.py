"""The port's examples (boxlcd_tpu_torch/examples) against the JAX
package's (examples/):

- MiniGPT from the flax init (carried over by research/nets/convert.py):
  logits and the loss within 1e-5 of flax's, bits/dim = nll / ln 2; one
  Adam step (lr 5e-4) against optax: parameters within 1e-5 wherever the
  gradient is at least 1e-6 (below that Adam's first step
  lr * g / (|g| + eps) is ill-conditioned, tests/test_torch_arbiters.py's
  adam_step_close: there within lr); `sample` given JAX's uniforms equal
  to JAX's, bit for bit;
- basic, less_basic (headless: the sine sweep written as a gif) and
  collect -> train end to end at a tiny size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.utils import AttrDict as JAttrDict
from boxlcd_tpu_torch.examples import basic, collect, less_basic, train
from boxlcd_tpu_torch.examples.model import Model
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from boxlcd_tpu_torch.utils import AttrDict
from examples.model import Model as JModel
from research.nets import dists as jdists

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TOL = 1e-5
WIDTHS = dict(n_embed=32, n_head=2, n_layer=2, window=6, lr=5e-4)


def host(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def pair():
  jenv = boxlcd_tpu.env_map['Bounce']()
  env = boxlcd_tpu_torch.env_map['Bounce'](device='cpu')
  jm = JModel(jenv, JAttrDict(WIDTHS))
  tm = Model(env, AttrDict(WIDTHS))
  load_flax(tm.module, host(jm.params))
  return jm, tm, env


def _batch(env, B=3, seed=0):
  rng = np.random.RandomState(seed)
  T = WIDTHS['window']
  return {'lcd': (rng.rand(B, T, env.lcd_h, env.lcd_w) > 0.5).astype(
              np.float32),
          'action': rng.uniform(-1, 1, (B, T, env.act_size)).astype(
              np.float32)}


def _close(got, want, tol=TOL):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
  assert err.max() <= tol, err.max()


def test_minigpt_forward_loss_and_adam_step(pair):
  jm, tm, env = pair
  batch = _batch(env)
  B, T = batch['lcd'].shape[:2]
  lcd = batch['lcd'].reshape(B, T, -1)
  with torch.no_grad():
    logits = tm.module(torch.as_tensor(lcd), torch.as_tensor(batch['action']))
  _close(logits, jm.module.apply(jm.params, lcd, batch['action']))

  def jloss(p):
    out = jm.module.apply(p, lcd, batch['action'])
    return -jdists.Bernoulli(out).log_prob(lcd).mean()
  jgrads = flax_to_state_dict(host(jax.jit(jax.grad(jloss))(jm.params)))
  before = {k: v.clone() for k, v in tm.module.state_dict().items()}
  # one step of each from the same parameters
  want = jm.train_step({k: jnp.asarray(v) for k, v in batch.items()})
  got = tm.train_step(batch)
  assert abs(got['loss'] - want['loss']) <= TOL
  assert abs(got['bits_per_dim'] - want['bits_per_dim']) <= TOL
  assert abs(got['bits_per_dim'] - got['loss'] / np.log(2)) <= 1e-6
  new = flax_to_state_dict(host(jm.params))
  lr = WIDTHS['lr']
  for k, p in tm.module.state_dict().items():
    big = np.abs(jgrads[k].numpy()) >= 1e-6
    assert big.any(), k
    _close(p.numpy()[big], new[k].numpy()[big])
    _close(p, new[k], lr)
    assert not torch.equal(p, before[k]), k


def test_minigpt_sample_matches_jax(pair):
  jm, tm, env = pair
  action = _batch(env, B=2, seed=1)['action']
  key = jax.random.PRNGKey(4)
  want = jm.sample(key, 2, jnp.asarray(action))
  # JAX's draws: position i's uniforms from split(key, T)[i]
  u = np.stack([np.asarray(jax.random.uniform(k, (2, tm.imsize)))
                for k in jax.random.split(key, WIDTHS['window'])])
  got = tm.sample(None, 2, action, u=torch.as_tensor(u))
  assert got.shape == (2, WIDTHS['window'], env.lcd_h * env.lcd_w)
  assert np.array_equal(got.numpy(), np.asarray(want))


def test_basic_prints_frames(capsys):
  printed = basic.main(['--steps=12', '--device=cpu'])
  assert sorted(printed) == [0, 10]
  out = capsys.readouterr().out
  assert '--- t=10' in out and '#' in out
  frame = printed[10]
  assert frame.shape == (16, 16) and frame.any() and not frame.all()


def test_less_basic_headless(tmp_path):
  path = less_basic.main(['--env=Dropbox', '--steps=4', '--headless=1',
                          f'--out={tmp_path / "lb.gif"}', '--device=cpu'])
  assert path == str(tmp_path / 'lb.gif')
  with Image.open(path) as im:
    assert im.n_frames == 4 and im.size == (16 * 8, 16 * 8)


def test_collect_then_train(tmp_path):
  out = tmp_path / 'rollouts.npz'
  traj = collect.main(['--num_eps=6', '--batch=4', '--ep_len=6',
                       f'--out={out}', '--device=cpu'])
  data = np.load(out)
  assert set(data) == {'lcd', 'proprio', 'full_state', 'action'}
  assert data['lcd'].shape == (6, 6, 16, 16)
  assert np.array_equal(data['lcd'], traj['lcd'])
  model, bpd, samp = train.main([f'--data={out}', '--epochs=2', '--bs=2',
                                 '--window=6', '--device=cpu'])
  assert len(bpd) == 2 and np.isfinite(bpd).all()
  assert samp.shape == (4, 6, 256)
  assert set(np.unique(samp.numpy())) <= {0.0, 1.0}
