"""The port's FBT against the JAX package's, from the same parameters (the
flax init of both the FBT and its frozen BVAE, carried over by
boxlcd_tpu_torch.research.nets.convert) on the same numpy-seeded inputs:
token logits and the loss (encode path and packed-z path), the precomputed
latents' bytes; and, as tests/test_models.py does for the JAX model
(:56, :141, :157, :184), finite initial gradients, the KV cache against the
full forward, precomputed z against the encode path, and the shapes of a
forward and a sample. Cached and uncached sampling give the same bits from
one generator state, and equal JAX's sample given JAX's uniforms.

Tolerance: 1e-5 absolute on logits and losses (float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets._base import global_norm
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.convert import load_flax
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from research.define_config import config as jconfig
from research.nets.autoencoders.bvae import BVAE as JBVAE
from research.nets.video_models.fbt import FBT as JFBT
from tests.test_torch_bvae import _close, fake_batch, tiny_G

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


def pair(name):
  """(JAX FBT, port FBT with the JAX one's FBT and BVAE parameters, env)."""
  jenv = boxlcd_tpu.env_map[name]()
  env = boxlcd_tpu_torch.env_map[name](device='cpu')
  jG, tG = tiny_G(jconfig, jenv), tiny_G(tconfig, env, device='cpu')
  jm = JFBT(jenv, jG, bvae=JBVAE(jenv, jG))
  tm = FBT(env, tG, bvae=BVAE(env, tG))
  host = lambda p: jax.tree_util.tree_map(np.asarray, p)
  load_flax(tm.bvae.module, host(jm.bvae.params))
  load_flax(tm.module, host(jm.params))
  return jm, tm, env


@pytest.fixture(scope='module', params=['Dropbox', 'Urchin'])
def models(request):
  return pair(request.param)


@pytest.fixture(scope='module')
def dropbox():
  return pair('Dropbox')


def _tokens(tm, B=2, seed=4):
  rng = np.random.RandomState(seed)
  T = tm.block_size
  z = (rng.rand(B, T, tm.z_size) > 0.5).astype(np.float32)
  a = rng.uniform(-1, 1, (B, T, tm.act_n)).astype(np.float32)
  return z, a


def test_logits_and_loss(models):
  jm, tm, env = models
  z, a = _tokens(tm)
  with torch.no_grad():
    logits = tm.module(torch.as_tensor(z), torch.as_tensor(a))
  _close(logits, jm.module.apply(jm.params, z, a))
  batch = fake_batch(env)
  key = jax.random.PRNGKey(0)
  jloss, _ = jm.loss_fn(jm.params, batch, key)
  with torch.no_grad():
    loss, _ = tm.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()})
  _close(loss, jloss)
  # the packed-z path: the JAX precompute_z's bytes, unpacked by both
  jz = jm.precompute_z({'lcd': jnp.asarray(batch['lcd'], jnp.uint8),
                        'proprio': jnp.asarray(batch['proprio'])}, chunk=2)
  with torch.no_grad():
    tz = tm.precompute_z({'lcd': torch.as_tensor(batch['lcd']).to(torch.uint8),
                          'proprio': torch.as_tensor(batch['proprio'])},
                         chunk=2)
  assert tz.dtype == torch.uint8 and (tz.numpy() == np.asarray(jz)).all()
  jl2, _ = jm.loss_fn(jm.params, {'z': jz, 'action': batch['action']}, key)
  with torch.no_grad():
    l2, _ = tm.loss_fn({'z': tz, 'action': torch.as_tensor(batch['action'])})
  _close(l2, jl2)


def test_fbt_init_grads_finite(dropbox):
  """As tests/test_models.py:141: the shift-right all-zero t=0 token through
  LayerNorm must not blow the initial gradients up."""
  _, tm, env = dropbox
  batch = {k: torch.as_tensor(v) for k, v in fake_batch(env).items()}
  tm.module.zero_grad()
  loss, _ = tm.loss_fn(batch)
  loss.backward()
  gnorm = float(global_norm([p.grad for p in tm.params]))
  assert np.isfinite(gnorm) and gnorm < 1e3, gnorm


def test_fbt_kv_cache_matches_full_forward(models):
  """Teacher-forced logits from the KV-cached `step` path against the full
  causal forward at every position (tests/test_models.py:157), and the
  JAX full forward."""
  jm, tm, _ = models
  z, a = _tokens(tm, seed=5)
  tz, ta = torch.as_tensor(z), torch.as_tensor(a)
  with torch.no_grad():
    full = tm.module(tz, ta)
    caches = tm.module.empty_cache(2)
    stepped = []
    for i in range(tm.block_size):
      zp = tz[:, i - 1] if i else torch.zeros_like(tz[:, 0])
      ap = ta[:, i - 1] if i else torch.zeros_like(ta[:, 0])
      logits, caches = tm.module.step(zp, ap, i, caches)
      stepped.append(logits)
  _close(torch.stack(stepped, 1), full)
  _close(torch.stack(stepped, 1), jm.module.apply(jm.params, z, a))


def test_fbt_precomputed_z_matches_encode_path(dropbox):
  """tests/test_models.py:184: the loss from bit-packed precomputed latents
  equals the loss that encodes the frames."""
  _, tm, env = dropbox
  batch = {k: torch.as_tensor(v) for k, v in fake_batch(env).items()}
  with torch.no_grad():
    l1, _ = tm.loss_fn(batch)
    z = tm.precompute_z({'lcd': batch['lcd'].to(torch.uint8),
                         'proprio': batch['proprio']}, chunk=2)
    l2, _ = tm.loss_fn({'z': z, 'action': batch['action']})
  assert z.shape[-1] == -(-tm.z_size // 8)
  _close(l1, l2)


def test_sample_cached_equals_uncached_and_jax(dropbox):
  jm, tm, env = dropbox
  batch = fake_batch(env)
  action = torch.as_tensor(batch['action'][:2])
  prompts = {k: torch.as_tensor(v[:2]) for k, v in batch.items()
             if k != 'action'}
  for kw in ({}, {'action': action}, {'action': action, 'prompts': prompts,
                                      'prompt_n': 3}):
    a = tm.sample(torch.Generator().manual_seed(1), 2, use_cache=True, **kw)
    b = tm.sample(torch.Generator().manual_seed(1), 2, use_cache=False, **kw)
    for k in a:
      assert torch.equal(a[k], b[k]), k
  # JAX's sample draws position i's uniforms from split(k_run, T)[i]
  key = jax.random.PRNGKey(3)
  _, k_run = jax.random.split(key)
  T = tm.block_size
  u = np.stack([np.asarray(jax.random.uniform(k, (2, tm.z_size)))
                for k in jax.random.split(k_run, T)])
  jprompts = {k: v[:2] for k, v in batch.items() if k != 'action'}
  js = jm.sample(key, 2, action=batch['action'][:2], prompts=jprompts,
                 prompt_n=3)
  ts = tm.sample(None, 2, action=action, prompts=prompts, prompt_n=3,
                 u=torch.as_tensor(u))
  _close(ts['lcd'], js['lcd'], 0)
  _close(ts['proprio'], js['proprio'])


def test_sample_keeps_its_float64_copy_until_the_weights_change():
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  G = tiny_G(tconfig, env, device='cpu')
  model = FBT(env, G, bvae=BVAE(env, G))
  net = model.serving_net()
  model.sample(torch.Generator().manual_seed(0), 2)
  assert model.serving_net() is net
  model.train_step(fake_batch(env))
  net = model.serving_net()
  for p, q in zip(model.module.parameters(), net.parameters()):
    assert q.dtype == torch.float64 and torch.equal(p.double(), q)
  assert model.serving_net() is net
  state = {k: torch.zeros_like(v) for k, v in model.module.state_dict().items()}
  model.module.load_state_dict(state)
  assert all(not q.any() for q in model.serving_net().parameters())


def test_fbt_forward_and_sample_shapes():
  """tests/test_models.py:56 for the port, from its own init."""
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  G = tiny_G(tconfig, env, device='cpu')
  model = FBT(env, G, bvae=BVAE(env, G))
  batch = fake_batch(env)
  m = model.train_step(batch)
  assert np.isfinite(float(m['loss/total']))
  sample = model.sample(torch.Generator().manual_seed(0), 2)
  assert sample['lcd'].shape == (2, G.window, env.lcd_h, env.lcd_w)
  assert sample['proprio'].shape == (2, G.window, max(1, env.pobs_size))
  prompts = {k: torch.as_tensor(v[:2]) for k, v in batch.items()
             if k != 'action'}
  ps = model.sample(torch.Generator().manual_seed(0), 2,
                    action=torch.as_tensor(batch['action'][:2]),
                    prompts=prompts, prompt_n=3)
  assert ps['lcd'].shape == (2, G.window, env.lcd_h, env.lcd_w)
  # the frozen BVAE's parameters are not FBT's to train
  assert not any(p.requires_grad for p in model.bvae.module.parameters())
  assert {id(p) for p in model.params}.isdisjoint(
      id(p) for p in model.bvae.module.parameters())
