"""The port's GPT / GPTDist, FIT, FRNLD and RSSM against the JAX package's,
from the same parameters (the flax init, carried over by
boxlcd_tpu_torch.research.nets.convert) on the same numpy-seeded inputs:
logits, outputs and losses; RSSM's loss fed the normals of JAX's key
splits; each `sample` (and FIT's and FRNLD's `onestep`) fed JAX's
uniforms or normals, giving JAX's frames; one clipped Adam step per model
(`tests/test_torch_arbiters.adam_step_close`'s rule). Also the flax
GRUCell's conversion alone, and the registries' keys against JAX's.

Env: Urchin (16x32 frames, proprio). Tolerance: 1e-5 absolute on float32
outputs and losses; frames equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets import gpt as tgpt
from boxlcd_tpu_torch.research.nets import net_map
from boxlcd_tpu_torch.research.nets.autoencoders.rnlda import RNLDA
from boxlcd_tpu_torch.research.nets.common import GRUCell
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from boxlcd_tpu_torch.research.nets.video_models import (
    FIT, FRNLD, RSSM, video_map)
from research.define_config import config as jconfig
from research.nets import gpt as jgpt
from research.nets import net_map as jnet_map
from research.nets.autoencoders.rnlda import RNLDA as JRNLDA
from research.nets.video_models import video_map as jvideo_map
from research.nets.video_models.fit import FIT as JFIT
from research.nets.video_models.frnld import FRNLD as JFRNLD
from research.nets.video_models.rssm import RSSM as JRSSM
from tests.test_torch_arbiters import _close, _t, adam_step_close

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

# tiny widths; grad_clip below the initial gradient norms, so the Adam
# step's clip scales (adam_step_close asks for it)
WIDTHS = dict(hidden_size=32, nfilter=8, vqD=4, vqK=16, n_embed=32,
              n_head=2, n_layer=1, window=6, bs=4, lr=1e-3, grad_clip=0.01,
              free_nats=0.01, prompt_n=3)
B, T, PN = 4, 6, 3
NAMES = ['FIT', 'FRNLD', 'RSSM']


def tiny_G(config, env, **kw):
  G = config()
  G.update(WIDTHS, wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base, **kw)
  return G


def fake_batch(env, seed=0):
  rng = np.random.RandomState(seed)
  return {
      'lcd': (rng.rand(B, T, env.lcd_h, env.lcd_w) > 0.5).astype(np.float32),
      'proprio': rng.uniform(-1, 1, (B, T, env.pobs_size)).astype(np.float32),
      'action': rng.uniform(-1, 1, (B, T, env.act_size)).astype(np.float32),
  }


def host(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def models():
  """{name: (JAX model, port model with its parameters)} on Urchin, and
  the port env; FRNLD over a converted RNLDA. The JAX models' flax inits
  run jitted (op by op they take several times longer on the CPU)."""
  jenv = boxlcd_tpu.env_map['Urchin']()
  env = boxlcd_tpu_torch.env_map['Urchin'](device='cpu')
  jG, tG = tiny_G(jconfig, jenv), tiny_G(tconfig, env, device='cpu')
  with pytest.MonkeyPatch.context() as mp:
    for cls in (JRNLDA, JFIT, JFRNLD, JRSSM):
      mp.setattr(cls, 'init_params', lambda self, key, init=cls.init_params:
                 jax.jit(lambda k: init(self, k))(key))
    jron, tron = JRNLDA(jenv, jG), RNLDA(env, tG)
    load_flax(tron.module, host(jron.params))
    out = {'FIT': (JFIT(jenv, jG), FIT(env, tG)),
           'FRNLD': (JFRNLD(jenv, jG, ronald=jron),
                     FRNLD(env, tG, ronald=tron)),
           'RSSM': (JRSSM(jenv, jG), RSSM(env, tG))}
  for jm, tm in out.values():
    load_flax(tm.module, host(jm.params))
  return out, env


def japply(jm, *args, method=None, out=lambda r: r):
  """out(the JAX model's module applied), jitted: `out` takes the arrays
  from its distributions."""
  return jax.jit(lambda p, *a: out(jm.module.apply(p, *a, method=method)))(
      jm.params, *args)


def uniforms(keys, shape):
  """One jax.random.uniform draw a key, stacked: the draws of a JAX scan
  over positions (or of a single onestep)."""
  return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, shape))
                                   for k in keys]))


def rssm_normals(key, steps, n):
  """The (prior, posterior) normals of JAX `RSSM.observe(.., key)`:
  split(key, steps), each split again into the prior's and the
  posterior's key."""
  pairs = [jax.random.split(k) for k in jax.random.split(key, steps)]
  return tuple(torch.as_tensor(np.stack([
      np.asarray(jax.random.normal(p[j], (n, 64))) for p in pairs]))
      for j in (0, 1))


def rssm_imagine_normals(key, steps, n):
  """The normals of JAX `RSSM.imagine(.., key)`: split(key, steps)."""
  return torch.as_tensor(np.stack([np.asarray(jax.random.normal(k, (n, 64)))
                                   for k in jax.random.split(key, steps)]))


def test_gru_cell_conversion():
  """flax's GRUCell (rssm.py:39) and common.GRUCell from the converted
  parameters: the same carry, so the gates r, z, n stack in torch's
  order."""
  import flax.linen as fnn
  cell = fnn.GRUCell(features=8)
  rng = np.random.RandomState(0)
  h = rng.randn(3, 8).astype(np.float32)
  x = rng.randn(3, 5).astype(np.float32)
  params = cell.init(jax.random.PRNGKey(1), h, x)
  # nonzero biases, so a bias in the wrong gate shows
  params = jax.tree_util.tree_map(
      lambda p: p + 0.3 * jax.random.normal(jax.random.PRNGKey(2), p.shape),
      params)
  want, _ = cell.apply(params, h, x)
  tcell = load_flax(GRUCell(5, 8), host(params))
  with torch.no_grad():
    got = tcell(torch.as_tensor(h), torch.as_tensor(x))
  _close(got, want)
  assert set(flax_to_state_dict(host(params))) == {
      'weight_ih', 'weight_hh', 'bias_ih', 'bias_hn'}


def test_registries_match_jax():
  """JAX's video models in its order, then the port's own FBTDSV2."""
  assert list(video_map) == list(jvideo_map) + ['FBTDSV2']
  assert list(jvideo_map) == ['FBT', 'FIT', 'FRNLD', 'RSSM']
  assert list(net_map) == list(jnet_map) + ['FBTDSV2'] and \
      len(net_map) == 12


def test_gpt_and_gpt_dist():
  """GPT logits, and GPTDist's log_prob and its sample (through `sample`)
  from JAX's uniforms (tests/test_rl.py:87's shapes)."""
  Bd, Td, L, C = 2, 3, 5, 4
  jmod = jgpt.GPT(in_size=1, block_size=L, n_embed=16, n_head=2, n_layer=1,
                  cond=C)
  rng = np.random.RandomState(1)
  x = rng.uniform(-1, 1, (Bd, Td, C)).astype(np.float32)
  params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                              jnp.zeros((Bd * Td, L, 1)), x.reshape(-1, C))
  tmod = load_flax(tgpt.GPT(1, L, n_embed=16, n_head=2, n_layer=1, cond=C),
                   host(params))
  state = (rng.rand(Bd, Td, L) > 0.5).astype(np.float32)
  s = state.reshape(-1, L, 1)
  with torch.no_grad():
    logits = tmod(torch.as_tensor(s), torch.as_tensor(x.reshape(-1, C)))
  _close(logits.logits, jax.jit(lambda p, *a: jmod.apply(p, *a).logits)(
      params, s, x.reshape(-1, C)))
  jd = jgpt.GPTDist(jmod, params, jax.random.PRNGKey(3), x)
  td = tgpt.GPTDist(tmod, None, torch.as_tensor(x))
  with torch.no_grad():
    _close(td.log_prob(torch.as_tensor(state)), jax.jit(jd.log_prob)(state))
  # JAX's sample draws position i from split(key, block_size)[i]
  u = uniforms(jax.random.split(jax.random.PRNGKey(3), L), (Bd * Td, 1))
  _close(td.sample(u=u), jd.sample(), 0)


def _outputs(name, jm, tm, batch):
  """(port outputs, JAX outputs): the module's logits or regression
  outputs (FIT, FRNLD), RSSM's embedding and decoded frame logits."""
  tb = _t(batch)
  with torch.no_grad():
    if name == 'FIT':
      lcd = batch['lcd'].reshape(B, T, -1)
      return (tm.module(torch.as_tensor(lcd), tb['action']),
              japply(jm, lcd, batch['action']))
    if name == 'FRNLD':
      z = np.array(jax.jit(lambda b: jm.ronald.encode(
          jm.ronald.params, b, noise=False))(batch))
      _close(tm.ronald.encode(tb, noise=False), z)
      return (tm.module(torch.as_tensor(z), tb['action']),
              japply(jm, z, batch['action']))
    lcd = batch['lcd'].reshape(B * T, *batch['lcd'].shape[2:])
    pro = batch['proprio'].reshape(B * T, -1)
    emb = tm.module.encode(torch.as_tensor(lcd), torch.as_tensor(pro))
    _close(emb, japply(jm, lcd, pro, method='encode'))
    feat = np.random.RandomState(3).randn(B, 320).astype(np.float32)
    dec = tm.module.decode(torch.as_tensor(feat))
    jlogits, jmean = japply(jm, feat, method='decode', out=lambda d: (
        d['lcd'].logits, d['proprio'].mean))
    _close(dec['proprio'].mean, jmean)
    return dec['lcd'].logits, jlogits


def _loss_fn(name, tm, key):
  """The port's loss as a function of the batch, fed the draws JAX's
  loss_fn takes from `key` (RSSM's normals: split(key)[0] to observe)."""
  if name != 'RSSM':
    return tm.loss_fn
  eps = rssm_normals(jax.random.split(key)[0], T - 1, B)
  return lambda batch, gen=None: RSSM.loss_fn(tm, batch, gen, eps=eps)


@pytest.mark.parametrize('name', NAMES)
def test_outputs_and_loss(models, name):
  (jm, tm), env = models[0][name], models[1]
  assert set(flax_to_state_dict(host(jm.params))) == set(
      tm.module.state_dict())
  assert tm.num_vars == sum(int(np.prod(p.shape)) for p in
                            jax.tree_util.tree_leaves(jm.params))
  batch = fake_batch(env)
  got, want = _outputs(name, jm, tm, batch)
  _close(got, want)
  key = jax.random.PRNGKey(7)
  jloss, jmet = jax.jit(jm.loss_fn)(jm.params, batch, key)
  with torch.no_grad():
    loss, met = _loss_fn(name, tm, key)(_t(batch))
  assert set(met) == set(jmet)
  for k in jmet:
    _close(met[k], jmet[k])


@pytest.mark.parametrize('name', ['FIT', 'FRNLD'])
def test_onestep_with_jax_draws(models, name):
  """Learned-env serving: frame i from the window, fed the uniforms JAX's
  onestep draws from its key."""
  (jm, tm), env = models[0][name], models[1]
  batch = fake_batch(env, seed=1)
  key = jax.random.PRNGKey(11)
  size = tm.imsize if name == 'FIT' else tm.z_size
  u = uniforms([key], (B, size))[0]
  want = jax.jit(jm.onestep, static_argnums=2)(
      jm.params, {k: jnp.asarray(v) for k, v in batch.items()}, 2, key, 0.8)
  got = tm.onestep(_t(batch), 2, None, 0.8, u=u)
  _close(got['lcd'], want['lcd'], 0)
  _close(got['proprio'], want['proprio'])
  assert torch.equal(got['lcd'][:, 3:], _t(batch)['lcd'][:, 3:])


def _sample_draws(name, tm, key, n):
  """The draws JAX's prompted `sample(key, ...)` takes, as the port's
  sample takes them: FIT/FRNLD uniforms of split(split(key)[1], T); RSSM
  normals of split(key, 3)'s observe and imagine keys."""
  if name == 'RSSM':
    _, k_obs, k_img = jax.random.split(key, 3)
    return {'eps': {'observe': rssm_normals(k_obs, PN, n),
                    'imagine': rssm_imagine_normals(k_img, T - PN, n)}}
  size = tm.imsize if name == 'FIT' else tm.z_size
  return {'u': uniforms(jax.random.split(jax.random.split(key)[1], T),
                        (n, size))}


@pytest.mark.parametrize('name', NAMES)
def test_sample_with_jax_draws(models, name):
  """Prompted samples: the prompt, then the draws of JAX's sample."""
  (jm, tm), env = models[0][name], models[1]
  batch = fake_batch(env, seed=2)
  prompts = {k: v for k, v in batch.items() if k != 'action'}
  key = jax.random.PRNGKey(5)
  want = jax.jit(lambda k, a, p: jm.sample(k, B, action=a, prompts=p,
                                           prompt_n=PN))(
      key, batch['action'], prompts)
  got = tm.sample(None, B, action=_t(batch)['action'], prompts=_t(prompts),
                  prompt_n=PN, **_sample_draws(name, tm, key, B))
  assert got['lcd'].shape == (B, T, env.lcd_h, env.lcd_w)
  _close(got['lcd'], want['lcd'], 0)
  _close(got['proprio'], want['proprio'])
  if name != 'FRNLD':   # FRNLD decodes its prompt's latents
    assert torch.equal(got['lcd'][:, :PN], _t(batch)['lcd'][:, :PN])


@pytest.mark.parametrize('name', NAMES)
def test_one_clipped_adam_step(models, name):
  """One clipped Adam step of both packages from the same parameters, on
  copies, so the other tests keep the converted ones."""
  (jm0, tm0), env = models[0][name], models[1]
  tG = tm0.G
  if name == 'FRNLD':
    tm = FRNLD(env, tG, ronald=tm0.ronald)
  else:
    tm = type(tm0)(env, tG)
  tm.module.load_state_dict(tm0.module.state_dict())
  key = jax.random.PRNGKey(1)
  tm.loss_fn = _loss_fn(name, tm, key)
  adam_step_close(jm0, tm, fake_batch(env, seed=3), key)
  if name == 'FRNLD':   # the frozen RNLDA is not FRNLD's to train
    assert not any(p.requires_grad for p in tm.ronald.module.parameters())
    assert {id(p) for p in tm.params}.isdisjoint(
        id(p) for p in tm.ronald.module.parameters())


def test_rssm_serves_no_learned_env(models):
  _, tm = models[0]['RSSM']
  with pytest.raises(NotImplementedError):
    tm.onestep({}, 0, None)
