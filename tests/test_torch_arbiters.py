"""The port's ArbiterAE, MultiStepArbiter and ObjectLocalizer against the JAX
package's, from the same parameters (the flax init, carried over by
boxlcd_tpu_torch.research.nets.convert) on the same numpy-seeded batch:
the state dict covers the module, encode/decode and the frozen surfaces,
the losses, one clipped Adam step; and the frozen round trip,
`save_frozen` -> `runners.trainer.load_arbiter`, giving the same features.

Envs: Urchin (16x32 frames, proprio), Dropbox (16x16, no proprio: a
1-wide zero proprio) and, for the localizer, which needs an object,
UrchinCube (16x24: wh_ratio 1.5) and Dropbox. Tolerance: 1e-5 absolute on
features, logits and losses (float32); parameters after the Adam step
within 1e-6 (lr 1e-3).
"""
import pickle

import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders import (
    ArbiterAE, MultiStepArbiter, ObjectLocalizer)
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from boxlcd_tpu_torch.research.runners.trainer import load_arbiter
from research.define_config import config as jconfig
from research.nets.autoencoders.arbiter import ArbiterAE as JArbiterAE
from research.nets.autoencoders.multistep_arbiter import (
    MultiStepArbiter as JMultiStepArbiter)
from research.nets.autoencoders.object_localizer import (
    ObjectLocalizer as JObjectLocalizer)

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TOL = 1e-5
WIDTHS = dict(hidden_size=32, nfilter=8, window=5, bs=4, lr=1e-3)
PAIRS = {'ArbiterAE': (JArbiterAE, ArbiterAE),
         'MultiStepArbiter': (JMultiStepArbiter, MultiStepArbiter),
         'ObjectLocalizer': (JObjectLocalizer, ObjectLocalizer)}
CASES = [('ArbiterAE', 'Urchin'), ('ArbiterAE', 'Dropbox'),
         ('MultiStepArbiter', 'Urchin'), ('MultiStepArbiter', 'Dropbox'),
         ('ObjectLocalizer', 'UrchinCube'), ('ObjectLocalizer', 'Dropbox')]


def tiny_G(config, env, **kw):
  G = config()
  G.update(WIDTHS, wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base, **kw)
  return G


def fake_batch(env, B=4, T=5, seed=0):
  rng = np.random.RandomState(seed)
  return {
      'lcd': (rng.rand(B, T, env.lcd_h, env.lcd_w) > 0.5).astype(np.float32),
      'proprio': rng.uniform(-1, 1, (B, T, max(1, env.pobs_size))
                             ).astype(np.float32),
      'action': rng.uniform(-1, 1, (B, T, env.act_size)).astype(np.float32),
      'full_state': rng.uniform(-1, 1, (B, T, env.obs_size)
                                ).astype(np.float32),
  }


def _np(x):
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x)


def _close(ours, ref, tol=TOL):
  a, b = _np(ours), _np(ref)
  assert a.shape == b.shape, (a.shape, b.shape)
  err = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
  assert err <= tol, err


def _t(batch):
  return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flat(batch):
  return {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}


def pair(model, env_name, **kw):
  """(JAX model, port model with the JAX one's parameters, port env)."""
  jcls, tcls = PAIRS[model]
  jenv = boxlcd_tpu.env_map[env_name]()
  env = boxlcd_tpu_torch.env_map[env_name](device='cpu')
  jm = jcls(jenv, tiny_G(jconfig, jenv, **kw))
  tm = tcls(env, tiny_G(tconfig, env, device='cpu', **kw))
  load_flax(tm.module, jax.tree_util.tree_map(np.asarray, jm.params))
  return jm, tm, env


@pytest.fixture(scope='module', params=CASES, ids=['-'.join(c) for c in CASES])
def models(request):
  return (request.param[0], *pair(*request.param))


def test_converted_state_dict_covers_module(models):
  _, jm, tm, _ = models
  sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jm.params))
  assert set(sd) == set(tm.module.state_dict())
  assert tm.num_vars == sum(int(np.prod(p.shape)) for p in
                            jax.tree_util.tree_leaves(jm.params))


def test_forward_and_loss(models):
  name, jm, tm, env = models
  batch = fake_batch(env)
  tb = _t(batch)
  with torch.no_grad():
    loss, met = tm.loss_fn(tb)
  jloss, jmet = jax.jit(jm.loss_fn)(jm.params, batch, jax.random.PRNGKey(0))
  _close(loss, jloss)
  assert set(met) == set(jmet)
  for k in jmet:
    _close(met[k], jmet[k])
  with torch.no_grad():
    if name == 'MultiStepArbiter':
      z, act = tm.forward_frozen(tb)
      jz, jact = jm.forward_frozen(jm.params, batch)
      _close(z, jz)
      _close(act, jact)
      assert act.shape == (4, 4, env.act_size) and z.shape == (4, 256)
      dec, jdec = tm.decode(z), jm.decode(jm.params, jz)
      for k in ('lcd', 'proprio', 'action'):
        d, jd = dec[k], jdec[k]
        _close(d.logits if k == 'lcd' else d.mean,
               jd.logits if k == 'lcd' else jd.mean)
      assert dec['lcd'].logits.shape == (4, 5, env.lcd_h, env.lcd_w)
    elif name == 'ArbiterAE':
      flat = _flat(batch)
      z = tm.encode(_t(flat))
      jz = jm.encode(jm.params, flat)
      _close(z, jz)
      dec, jdec = tm.decode(z), jm.decode(jm.params, jz)
      _close(dec['lcd'].logits, jdec['lcd'].logits)
      _close(dec['proprio'].mean, jdec['proprio'].mean)
      assert dec['lcd'].logits.shape == (20, env.lcd_h, env.lcd_w)
    else:
      flat = _flat(batch)
      xy = tm.localize(torch.as_tensor(flat['lcd']),
                       torch.as_tensor(flat['proprio']))
      _close(xy, jm.localize(jm.params, flat['lcd'], flat['proprio']))
      assert xy.shape == (20, 2)
      assert list(tm.idxs) == list(jm.idxs) and len(tm.idxs) == 2


def adam_step_close(jm, tm, batch, key):
  """One clipped Adam step of both packages from the same parameters: the
  gradients within 1e-5 of each tensor's largest (float32 sums in another
  order), the parameters after within 1e-6
  wherever the gradient is at least 1e-6 (100x Adam's eps). Below that,
  Adam's first step lr * g / (|g| + eps) is ill-conditioned (its slope
  lr * eps / (|g| + eps)^2 reaches lr / eps = 1e5), so a float32 rounding
  of the gradient moves it visibly: there the two steps agree within their
  size, lr. Returns the number of such entries."""
  jgrads = jax.jit(jax.grad(lambda p: jm.loss_fn(p, batch, key)[0]))(
      jm.params)
  params, _, jmet = jm._update(jm.params, jm.opt_state, batch, key)
  met = tm.update(_t(batch), None)
  grads = {k: p.grad for k, p in tm.module.named_parameters()}
  assert float(jmet['grad_norm']) > tm.grad_clip     # the clip scales
  _close(met['grad_norm'], jmet['grad_norm'], 1e-5 * float(jmet['grad_norm']))
  want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
  want_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
  got = tm.module.state_dict()
  scale = tm.grad_clip / float(jmet['grad_norm'])   # grads are clipped
  small = 0
  for k in want:
    _close(grads[k] / scale, want_g[k],
           1e-5 * float(want_g[k].abs().max()) + 1e-9)
    big = np.abs(want_g[k].numpy()) * scale >= 1e-6
    small += int((~big).sum())
    if big.any():
      _close(got[k].numpy()[big], want[k].numpy()[big], 1e-6)
    _close(got[k], want[k], float(tm.G.lr))
  return small


@pytest.mark.parametrize('name,env_name', [
    ('ArbiterAE', 'Urchin'), ('MultiStepArbiter', 'Urchin'),
    ('ObjectLocalizer', 'UrchinCube')])
def test_one_clipped_adam_step(name, env_name):
  # grad_clip 0.05: the step's global norm is above it, so the clip scales
  jm, tm, env = pair(name, env_name, grad_clip=0.05)
  adam_step_close(jm, tm, fake_batch(env, seed=2), jax.random.PRNGKey(1))


@pytest.mark.parametrize('name', ['ArbiterAE', 'MultiStepArbiter'])
def test_frozen_round_trip(name, tmp_path):
  """`save` writes the checkpoint and the frozen net; load_arbiter builds
  it back (its own G, the caller's env) with the same features."""
  _, tm, env = pair(name, 'Urchin')
  batch = _t(fake_batch(env, seed=3))
  tm.train_step(fake_batch(env, seed=4))     # weights off their init
  tm.save(tmp_path)
  assert {p.name for p in tmp_path.iterdir()} == {f'{name}.pkl',
                                                  f'{name}.frozen.pkl'}
  with open(tmp_path / f'{name}.frozen.pkl', 'rb') as f:
    blob = pickle.load(f)
  assert blob['kind'] == name and blob['G']['window'] == 5
  G = tconfig()
  G.arbiterdir = tmp_path
  arb = load_arbiter(G, env)
  assert arb['kind'] == name
  assert not any(p.requires_grad for p in arb['module'].parameters())
  with torch.no_grad():
    if name == 'MultiStepArbiter':
      assert arb['window'] == 5
      z, act = arb['fn'](batch)
      want_z, want_act = tm.forward_frozen(batch)
      assert torch.equal(act, want_act)
    else:
      assert arb['window'] is None
      flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
      z, act = arb['fn'](flat)
      want_z = tm.encode(flat)
      assert act is None
  assert torch.equal(z, want_z)


def test_load_arbiter_refuses_other_frozen_nets(tmp_path):
  """The localizer's frozen file (what the learned env reads) is not an
  arbiter."""
  _, tm, env = pair('ObjectLocalizer', 'Dropbox')
  path = tm.save_frozen(tmp_path)
  assert path.name == 'ObjectLocalizer.frozen.pkl'
  G = tconfig()
  G.arbiterdir = tmp_path
  with pytest.raises(ValueError, match='not an arbiter'):
    load_arbiter(G, env)
