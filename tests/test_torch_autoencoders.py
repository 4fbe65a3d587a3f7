"""The port's VAE, RNLDA and VQVAE against the JAX package's, from the same
parameters (the flax init, carried over by
boxlcd_tpu_torch.research.nets.convert; VQVAE's codebook included) on the
same numpy-seeded batch: the state dict covers the module, encode/decode,
the loss with the JAX-drawn noise handed to the port (the VAE's posterior
normals, RNLDA's quantizer uniforms; streams are never compared), one
clipped Adam step; and the registries.

Envs: Urchin (16x32) and Dropbox (16x16, no proprio). Tolerance: 1e-5
absolute on z, logits and losses (float32); the Adam step as
tests/test_torch_arbiters.py's `adam_step_close` states it.
"""
import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets import net_map
from boxlcd_tpu_torch.research.nets.autoencoders import (
    RNLDA, VAE, VQVAE, ae_map)
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from research.define_config import config as jconfig
from research.nets import net_map as jnet_map
from research.nets.autoencoders import ae_map as jae_map
from tests.test_torch_arbiters import (
    _close, _flat, _t, adam_step_close, fake_batch, tiny_G)

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

WIDTHS = dict(vqD=8, vqK=16)
PORTS = {'VAE': VAE, 'RNLDA': RNLDA, 'VQVAE': VQVAE}
CASES = [(m, e) for m in PORTS for e in ('Urchin', 'Dropbox')]


def pair(model, env_name, **kw):
  """(JAX model, port model with the JAX one's parameters, port env)."""
  jenv = boxlcd_tpu.env_map[env_name]()
  env = boxlcd_tpu_torch.env_map[env_name](device='cpu')
  jm = jae_map[model](jenv, tiny_G(jconfig, jenv, **WIDTHS, **kw))
  tm = PORTS[model](env, tiny_G(tconfig, env, device='cpu', **WIDTHS, **kw))
  load_flax(tm.module, jax.tree_util.tree_map(np.asarray, jm.params))
  return jm, tm, env


def noise(name, tm, key, frames):
  """The noise the JAX loss draws from `key`, as the port's loss takes it."""
  if name == 'VAE':
    return {'eps': torch.as_tensor(np.asarray(
        jax.random.normal(key, (frames, tm.z_size))))}
  if name == 'RNLDA':
    return {'u': torch.as_tensor(np.asarray(jax.random.uniform(
        key, (frames, tm.zH, tm.zW, tm.G.vqD))))}
  return {}


@pytest.fixture(scope='module', params=CASES, ids=['-'.join(c) for c in CASES])
def models(request):
  return (request.param[0], *pair(*request.param))


def test_registries_hold_the_jax_models_in_order():
  assert list(ae_map) == list(jae_map) == [
      'BVAE', 'VAE', 'RNLDA', 'ArbiterAE', 'MultiStepArbiter',
      'ObjectLocalizer', 'VQVAE']
  # all four video models after the seven autoencoders, as in JAX; then
  # the port's own FBTDSV2
  assert list(jnet_map) == list(ae_map) + ['FBT', 'FIT', 'FRNLD', 'RSSM']
  assert list(net_map) == list(jnet_map) + ['FBTDSV2']


def test_converted_state_dict_covers_module(models):
  name, jm, tm, _ = models
  sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jm.params))
  assert set(sd) == set(tm.module.state_dict())
  if name == 'VQVAE':
    assert 'vq.embedding' in sd
  assert tm.num_vars == sum(int(np.prod(p.shape)) for p in
                            jax.tree_util.tree_leaves(jm.params))


def test_encode_decode_and_loss(models):
  name, jm, tm, env = models
  batch = fake_batch(env, seed=1)
  flat = _flat(batch)
  with torch.no_grad():
    z = tm.encode(_t(flat))
    jz = jm.encode(jm.params, flat)
    _close(z, jz)
    dec, jdec = tm.decode(z), jm.decode(jm.params, jz)
    _close(dec['lcd'].logits, jdec['lcd'].logits)
    _close(dec['proprio'].mean, jdec['proprio'].mean)
    assert dec['lcd'].logits.shape == (20, env.lcd_h, env.lcd_w)
    # (B, T, ...) batches keep their time axis where the JAX model does
    if name != 'VQVAE':
      _close(tm.encode(_t(batch)), jm.encode(jm.params, batch))
  key = jax.random.PRNGKey(7)
  jloss, jmet = jax.jit(jm.loss_fn)(jm.params, batch, key)
  with torch.no_grad():
    loss, met = tm.loss_fn(_t(batch), **noise(name, tm, key, 20))
  _close(loss, jloss)
  assert set(met) == set(jmet)
  for k in jmet:
    _close(met[k], jmet[k])


@pytest.mark.parametrize('name', list(PORTS))
def test_one_clipped_adam_step(name):
  jm, tm, env = pair(name, 'Urchin', grad_clip=0.05)
  key = jax.random.PRNGKey(11)
  extra = noise(name, tm, key, 20)
  loss_fn = PORTS[name].loss_fn
  tm.loss_fn = lambda b, gen: loss_fn(tm, b, gen, **extra)
  adam_step_close(jm, tm, fake_batch(env, seed=2), key)


@pytest.mark.parametrize('name', list(PORTS))
def test_trains_and_samples(name):
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  model = PORTS[name](env, tiny_G(tconfig, env, device='cpu', **WIDTHS))
  batch = fake_batch(env)
  first = model.train_step(batch)
  for _ in range(30):
    m = model.train_step(batch)
  key = 'loss/vae_loss' if name == 'VAE' else 'loss/total'
  assert m[key] < first[key], 'loss should decrease'
  s = model.sample(model.gen, 3)
  assert s['lcd'].shape == (3, env.lcd_h, env.lcd_w)
  assert s['proprio'].shape == (3, 1)
  metrics = model.evaluate(None, batch, 31)
  assert np.isfinite(list(metrics.values())).all()
