"""The port's model building blocks against the JAX package's, on the same
numpy-seeded inputs and the same parameters (flax init, carried over by
boxlcd_tpu_torch.research.nets.convert): distributions, quantizers (the
straight-through gradient included), attention full and KV-cached, the
transformer block, ResBlock, Upsample and flax's stride-2 'SAME' convolution.

Tolerance: 1e-5 absolute in float32 unless a test says why more. Random
draws are never compared: where a function samples, both sides get the same
JAX-drawn uniforms.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxlcd_tpu_torch.research.nets import common, dists, quantize
from boxlcd_tpu_torch.research.nets.convert import load_flax
from research.nets import common as jcommon
from research.nets import dists as jdists
from research.nets import quantize as jquantize

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TOL = 1e-5


def _rng(seed=0):
  return np.random.default_rng(seed)


def _close(ours, ref, tol=TOL):
  ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
  ref = np.asarray(ref)
  assert ours.shape == ref.shape, (ours.shape, ref.shape)
  err = np.abs(ours.astype(np.float64) - ref.astype(np.float64)).max()
  assert err <= tol, err


def _init(module, *args):
  params = module.init(jax.random.PRNGKey(0), *args)
  return jax.tree_util.tree_map(np.asarray, params)


def _t(x):
  return torch.as_tensor(np.array(x))


# -- dists ---------------------------------------------------------------------

def test_bernoulli():
  r = _rng(1)
  logits = (r.standard_normal((4, 7)) * 6).astype(np.float32)
  x = (r.random((4, 7)) > 0.5).astype(np.float32)
  u = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (4, 7)))
  j, t = jdists.Bernoulli(jnp.asarray(logits)), dists.Bernoulli(_t(logits))
  _close(t.log_prob(_t(x)), j.log_prob(jnp.asarray(x)))
  _close(t.entropy(), j.entropy())
  _close(t.probs, j.probs)
  _close(t.mode, j.mode)
  for temp in (1.0, 0.5):
    # jdists.Bernoulli.sample draws exactly these uniforms from the key
    _close(t.sample(temp=temp, u=_t(u)),
           j.sample(jax.random.PRNGKey(3), temp=temp), 0)


def test_normal_and_categorical_and_mog():
  r = _rng(2)
  mean = r.standard_normal((3, 5)).astype(np.float32)
  std = r.uniform(0.1, 2.0, (3, 5)).astype(np.float32)
  mean2 = r.standard_normal((3, 5)).astype(np.float32)
  std2 = r.uniform(0.1, 2.0, (3, 5)).astype(np.float32)
  x = r.standard_normal((3, 5)).astype(np.float32)
  jn, tn = jdists.Normal(mean, std), dists.Normal(_t(mean), _t(std))
  _close(tn.log_prob(_t(x)), jn.log_prob(x))
  _close(tn.kl(dists.Normal(_t(mean2), _t(std2))),
         jn.kl(jdists.Normal(mean2, std2)))
  _close(tn.entropy(), jn.entropy())
  eps = r.standard_normal((3, 5)).astype(np.float32)
  _close(tn.sample(eps=_t(eps)), mean + std * eps)
  logits = r.standard_normal((6, 4)).astype(np.float32) * 3
  idx = r.integers(0, 4, 6)
  jc, tc = jdists.Categorical(logits), dists.Categorical(_t(logits))
  _close(tc.log_prob(_t(idx)), jc.log_prob(jnp.asarray(idx)))
  _close(tc.entropy(), jc.entropy())
  _close(tc.probs, jc.probs)
  mlog = r.standard_normal((6, 3)).astype(np.float32)
  means = r.standard_normal((6, 3, 2)).astype(np.float32)
  stds = r.uniform(0.2, 1.5, (6, 3, 2)).astype(np.float32)
  y = r.standard_normal((6, 2)).astype(np.float32)
  jm = jdists.MixtureOfGaussians(mlog, means, stds)
  tm = dists.MixtureOfGaussians(_t(mlog), _t(means), _t(stds))
  _close(tm.log_prob(_t(y)), jm.log_prob(y))
  _close(tm.mean, jm.mean)
  assert tm.sample(torch.Generator().manual_seed(0)).shape == (6, 2)


# -- quantize ------------------------------------------------------------------

@pytest.mark.parametrize('noise', [False, True])
def test_binary_quantize_and_straight_through_grad(noise):
  r = _rng(3)
  logits = (r.standard_normal((2, 4, 8, 16)) * 3).astype(np.float32)
  key = jax.random.PRNGKey(5)
  u = np.asarray(jax.random.uniform(key, logits.shape))
  zq, ent, probs = jquantize.binary_quantize(jnp.asarray(logits), key, noise)
  tl = _t(logits).requires_grad_(True)
  tzq, tent, tprobs = quantize.binary_quantize(tl, noise=noise, u=_t(u))
  _close(tzq, zq)
  _close(tent, ent)
  _close(tprobs, probs)
  w = r.standard_normal(logits.shape).astype(np.float32)
  g = jax.grad(lambda z: (jquantize.binary_quantize(z, key, noise)[0]
                          * w).sum())(jnp.asarray(logits))
  (tzq * _t(w)).sum().backward()
  _close(tl.grad, g)
  assert np.abs(np.asarray(g)).sum() > 0


def test_rnld_and_vector_quantizer():
  r = _rng(4)
  z = (r.standard_normal((5, 6)) * 2).astype(np.float32)
  key = jax.random.PRNGKey(2)
  u = np.asarray(jax.random.uniform(key, z.shape))
  for noise in (False, True):
    jq, jidx = jquantize.rnld(jnp.asarray(z), key, noise)
    tq, tidx = quantize.rnld(_t(z), noise=noise, u=_t(u))
    _close(tq, jq)
    assert (tidx.numpy() == np.asarray(jidx)).all()
  x = r.standard_normal((3, 4, 8)).astype(np.float32)
  jvq = jquantize.VectorQuantizer(K=16, D=8, beta=0.25)
  params = _init(jvq, x)
  tvq = quantize.VectorQuantizer(16, 8, 0.25)
  tvq.embedding.data = _t(params['params']['embedding'])
  jout = jvq.apply(params, x)
  tout = tvq(_t(x))
  for a, b in zip(tout[:3], jout[:3]):
    _close(a, b)
  assert (tout[3].numpy() == np.asarray(jout[3])).all()


# -- attention and transformer block -------------------------------------------

def _cached_run(apply_step, cache, x):
  outs = []
  for i in range(x.shape[1]):
    y, cache = apply_step(x[:, i:i + 1], cache, i)
    outs.append(y)
  return outs


@pytest.mark.parametrize('kind', ['attn', 'block'])
def test_attention_full_and_cached(kind):
  E, H, S, B, T = 32, 4, 7, 3, 7
  x = _rng(5).standard_normal((B, T, E)).astype(np.float32)
  if kind == 'attn':
    jm, tm = (jcommon.CausalSelfAttention(E, H, S),
              common.CausalSelfAttention(E, H, S))
  else:
    jm, tm = (jcommon.TransformerBlock(E, H, S),
              common.TransformerBlock(E, H, S))
  params = _init(jm, x)
  load_flax(tm, params)
  _close(tm(_t(x)), jm.apply(params, x))
  # the KV cache: one token a call, written at its index
  zeros = lambda: jnp.zeros((B, H, S, E // H))
  jout = _cached_run(lambda xi, c, i: jm.apply(params, xi, c, i),
                     (zeros(), zeros()), jnp.asarray(x))
  tz = lambda: torch.zeros((B, H, S, E // H))
  tout = _cached_run(lambda xi, c, i: tm(xi, c, i), (tz(), tz()), _t(x))
  for a, b in zip(tout, jout):
    _close(a, b)
  # the cached path equals the full forward too
  _close(torch.cat(tout, 1), jm.apply(params, x))


# -- conv blocks ---------------------------------------------------------------

@pytest.mark.parametrize('hw', [(16, 32), (32, 32), (8, 16), (4, 8)])
def test_stride2_same_conv(hw):
  x = _rng(6).standard_normal((2, *hw, 5)).astype(np.float32)
  jconv = fnn.Conv(7, (3, 3), strides=(2, 2), padding='SAME')
  params = _init(jconv, x)
  tconv = load_flax(common.Conv(5, 7, 3, stride=2), params)
  ours = tconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  _close(ours, jconv.apply(params, x))
  # torch's symmetric padding=1 would shift every output: the pads differ
  assert common.same_pad(hw[0], 3, 2) == (0, 1)


@pytest.mark.parametrize('out_ch', [None, 12])
def test_resblock(out_ch):
  r = _rng(7)
  x = r.standard_normal((2, 8, 16, 8)).astype(np.float32)
  emb = r.standard_normal((2, 10)).astype(np.float32)
  jm = jcommon.ResBlock(8, 10, out_channels=out_ch, group_size=4)
  params = _init(jm, x, emb)
  # the zero-initialised last conv would hide the main branch: randomise it
  params = jax.tree_util.tree_map(
      lambda p: p + 0.1 * r.standard_normal(p.shape).astype(np.float32),
      params)
  tm = load_flax(common.ResBlock(8, 10, out_channels=out_ch, group_size=4),
                 params)
  ours = tm(_t(x).permute(0, 3, 1, 2), _t(emb)).permute(0, 2, 3, 1)
  _close(ours, jm.apply(params, x, emb))


def test_upsample_nearest_and_conv():
  x = _rng(8).standard_normal((2, 4, 8, 3)).astype(np.float32)
  up = jax.image.resize(x, (2, 8, 16, 3), 'nearest')
  ours = _t(x).permute(0, 3, 1, 2).repeat_interleave(2, -2) \
      .repeat_interleave(2, -1).permute(0, 2, 3, 1)
  _close(ours, up, 0)
  jm = jcommon.Upsample(6)
  params = _init(jm, x)
  tm = load_flax(common.Upsample(3, 6), params)
  _close(tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
         jm.apply(params, x))


def test_heads_and_aggregate():
  r = _rng(9)
  x = r.standard_normal((5, 12)).astype(np.float32)
  jg = jcommon.GaussHead(3)
  pg = _init(jg, x)
  tg = load_flax(common.GaussHead(12, 3), pg)
  past = r.standard_normal((5, 3)).astype(np.float32)
  jd, td = jg.apply(pg, x, past), tg(_t(x), _t(past))
  _close(td.mean, jd.mean)
  _close(td.std, jd.std)
  jmdn = jcommon.MDNHead(4, mdn_k=3)
  pm = _init(jmdn, x)
  tmdn = load_flax(common.MDNHead(12, 4, mdn_k=3), pm)
  y = r.standard_normal((5, 4)).astype(np.float32)
  _close(tmdn(_t(x)).log_prob(_t(y)), jmdn.apply(pm, x).log_prob(y))
  for jh, th in ((jcommon.BinaryHead(6), common.BinaryHead(12, 6)),
                 (jcommon.CategoricalHead(6), common.CategoricalHead(12, 6))):
    ph = _init(jh, x)
    _close(load_flax(th, ph)(_t(x)).logits, jh.apply(ph, x).logits)
  z = r.standard_normal((4, 6, 3)).astype(np.float32)
  _close(common.aggregate(_t(z)), jcommon.aggregate(jnp.asarray(z)))
  zm = common.zero_params(common.Dense(3, 4))
  assert all((p == 0).all() for p in zm.parameters())
