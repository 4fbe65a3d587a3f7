"""The port's BVAE against the JAX package's, from the same parameters (the
flax init, carried over by boxlcd_tpu_torch.research.nets.convert) on the
same numpy-seeded batch: encode, decode, the loss with noise off and with
JAX-drawn quantizer noise injected, one clipped Adam step; and, as
tests/test_models.py:39 does for the JAX model, that it trains.

Envs: Dropbox (16x16, no proprio) and Urchin (16x32: the stride-2 'SAME'
convolutions pad 16 -> 8 -> 4 and 32 -> 16 -> 8 asymmetrically).
Tolerance: 1e-5 absolute on logits, z and losses (float32); parameters
after the Adam step within 1e-6 (lr 1e-3: one step moves a parameter by at
most ~lr).
"""
import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from research.define_config import config as jconfig
from research.nets.autoencoders.bvae import BVAE as JBVAE

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TOL = 1e-5
WIDTHS = dict(hidden_size=32, nfilter=16, vqD=8, vqK=16, n_embed=32,
              n_head=2, n_layer=1, window=6, bs=4, lr=1e-3)


def tiny_G(config, env, **kw):
  G = config()
  G.update(WIDTHS, wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base, **kw)
  return G


def fake_batch(env, B=4, T=6, seed=0):
  rng = np.random.RandomState(seed)
  return {
      'lcd': (rng.rand(B, T, env.lcd_h, env.lcd_w) > 0.5).astype(np.float32),
      'proprio': rng.uniform(-1, 1, (B, T, max(1, env.pobs_size))
                             ).astype(np.float32),
      'action': rng.uniform(-1, 1, (B, T, env.act_size)).astype(np.float32),
  }


def _np(x):
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x)


def _close(ours, ref, tol=TOL):
  a, b = _np(ours), _np(ref)
  assert a.shape == b.shape, (a.shape, b.shape)
  err = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
  assert err <= tol, err


def pair(name, **kw):
  """(JAX BVAE, port BVAE with the JAX one's parameters, env)."""
  jenv = boxlcd_tpu.env_map[name]()
  env = boxlcd_tpu_torch.env_map[name](device='cpu')
  jm = JBVAE(jenv, tiny_G(jconfig, jenv, **kw))
  tm = BVAE(env, tiny_G(tconfig, env, device='cpu', **kw))
  load_flax(tm.module, jax.tree_util.tree_map(np.asarray, jm.params))
  return jm, tm, env


@pytest.fixture(scope='module', params=['Dropbox', 'Urchin'])
def models(request):
  return pair(request.param)


def test_converted_state_dict_covers_module(models):
  jm, tm, _ = models
  sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jm.params))
  assert set(sd) == set(tm.module.state_dict())
  assert tm.num_vars == sum(int(np.prod(p.shape)) for p in
                            jax.tree_util.tree_leaves(jm.params))


def test_encode_decode(models):
  jm, tm, env = models
  batch = fake_batch(env)
  flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
  tflat = {k: torch.as_tensor(v) for k, v in flat.items()}
  with torch.no_grad():
    z_e = tm.module.enc(tflat['lcd'], tflat['proprio'])
    _close(z_e, jm.module.apply(jm.params, flat['lcd'], flat['proprio'],
                                method='enc'))
    z = tm.encode(tflat)
    jz = jm.encode(jm.params, flat)
    _close(z, jz)
    assert z.shape == (24, tm.z_size)
    # (B, T, ...) batches keep their time axis
    _close(tm.encode({k: torch.as_tensor(v) for k, v in batch.items()}),
           jm.encode(jm.params, batch))
    dec, jdec = tm.decode(z), jm.decode(jm.params, jz)
    _close(dec['lcd'].logits, jdec['lcd'].logits)
    _close(dec['proprio'].mean, jdec['proprio'].mean)
    assert dec['lcd'].logits.shape == (24, env.lcd_h, env.lcd_w)
    # the public z is (zH, zW, vqD)-ordered: unflatten_z inverts encode
    _close(tm.unflatten_z(z), jm.unflatten_z(jz))


def test_loss_without_and_with_noise(models):
  jm, tm, env = models
  batch = fake_batch(env, seed=1)
  tb = {k: torch.as_tensor(v) for k, v in batch.items()}
  key = jax.random.PRNGKey(7)
  jloss, jmet = jm.loss_fn(jm.params, batch, key)
  # the JAX loss draws its quantizer uniforms from `key` at z's shape
  u = np.asarray(jax.random.uniform(key, (24, tm.zH, tm.zW, tm.G.vqD)))
  with torch.no_grad():
    loss, met = tm.loss_fn(tb, u=torch.as_tensor(u))
  _close(loss, jloss)
  for k in jmet:
    _close(met[k], jmet[k])
  # noise off: the encode-time quantizer, through both losses' pieces
  with torch.no_grad():
    zq = tm.encode(tb)
    dec = tm.decode(zq.reshape(-1, tm.z_size))
  jzq = jm.encode(jm.params, batch)
  jdec = jm.decode(jm.params, jzq.reshape(-1, jm.z_size))
  lcd = batch['lcd'].reshape(-1, env.lcd_h, env.lcd_w)
  _close(dec['lcd'].log_prob(torch.as_tensor(lcd)).mean(),
         jdec['lcd'].log_prob(lcd).mean())


def test_one_clipped_adam_step():
  # grad_clip 0.05: the step's global norm is above it, so the clip scales
  jm, tm, env = pair('Urchin', grad_clip=0.05)
  batch = fake_batch(env, seed=2)
  key = jax.random.PRNGKey(11)
  u = torch.as_tensor(np.asarray(
      jax.random.uniform(key, (24, tm.zH, tm.zW, tm.G.vqD))))
  params, _, jmet = jm._update(jm.params, jm.opt_state, batch, key)
  tm.loss_fn = lambda b, gen: BVAE.loss_fn(tm, b, gen, u=u)
  met = tm.update({k: torch.as_tensor(v) for k, v in batch.items()}, None)
  assert float(jmet['grad_norm']) > 0.05
  _close(met['grad_norm'], jmet['grad_norm'], 1e-5 * float(jmet['grad_norm']))
  _close(met['loss/total'], jmet['loss/total'])
  want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
  got = tm.module.state_dict()
  for k in want:
    _close(got[k], want[k], 1e-6)


def test_bvae_trains():
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  model = BVAE(env, tiny_G(tconfig, env, device='cpu'))
  batch = fake_batch(env)
  first = model.train_step(batch)
  for _ in range(10):
    m = model.train_step(batch)
  assert m['loss/total'] < first['loss/total'], 'loss should decrease'
  assert model.step == 11
  flat = {k: torch.as_tensor(v.reshape(-1, *v.shape[2:]))
          for k, v in batch.items()}
  z = model.encode(flat, noise=False)
  assert z.shape == (24, model.z_size)
  assert model.decode(z)['lcd'].logits.shape == (24, env.lcd_h, env.lcd_w)
