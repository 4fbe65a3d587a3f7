"""The port's model diagnostics against the JAX package's, on the CPU:
fit_diag's isolated-pixel fraction and teacher-forced numbers, and
model_probe's three blocks, on flax weights carried over by
convert.load_flax and the same inputs (the probes' real batch:
tests/test_torch_real_batch.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.convert import load_flax
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.nets.video_models.fit import FIT
from boxlcd_tpu_torch.research.scripts import fit_diag, model_probe
from research.define_config import config as jconfig
from research.nets import dists as jdists
from research.nets.autoencoders.bvae import BVAE as JBVAE
from research.nets.video_models.fbt import FBT as JFBT
from research.nets.video_models.fit import FIT as JFIT
from research.scripts import fit_diag as jfit_diag

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

WIDTHS = dict(hidden_size=32, nfilter=8, vqD=4, vqK=16, n_embed=32,
              n_head=2, n_layer=1, window=6, bs=4, lr=1e-3)
G_ENV = {'vel_iters': 8, 'pos_iters': 4}


def test_isolated_frac_equals_jax():
  rng = np.random.default_rng(1)
  frames = (rng.random((12, 16, 32)) > 0.3).astype(np.float32)
  frames[3] = 1.0                       # a blank frame: no ink at all
  assert fit_diag.isolated_frac(frames) == jfit_diag.isolated_frac(frames)
  assert 0 < fit_diag.isolated_frac(frames) < 1
  assert fit_diag.isolated_frac(np.ones((2, 4, 4))) == 0.0


def _batch(env, B, T, seed=0):
  rng = np.random.RandomState(seed)
  return {
      'lcd': (rng.rand(B, T, env.lcd_h, env.lcd_w) > 0.5).astype(
          np.float32),
      'proprio': rng.uniform(-1, 1, (B, T, env.pobs_size)).astype(
          np.float32),
      'action': rng.uniform(-1, 1, (B, T, env.act_size)).astype(np.float32),
  }


def _G(config, env, **kw):
  G = config()
  G.update(WIDTHS, wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base, **kw)
  return G


@pytest.fixture(scope='module')
def models():
  """(JAX FIT, BVAE, FBT), (the port's, with JAX's flax inits), the port
  env; the flax inits run jitted."""
  jenv = boxlcd_tpu.env_map['Urchin'](G_ENV)
  env = boxlcd_tpu_torch.env_map['Urchin'](G_ENV, device='cpu')
  jG, tG = _G(jconfig, jenv), _G(tconfig, env, device='cpu')
  with pytest.MonkeyPatch.context() as mp:
    for cls in (JFIT, JBVAE, JFBT):
      mp.setattr(cls, 'init_params', lambda self, key, init=cls.init_params:
                 jax.jit(lambda k: init(self, k))(key))
    jfit, jbvae = JFIT(jenv, jG), JBVAE(jenv, jG)
    jfbt = JFBT(jenv, jG, bvae=jbvae)
  tfit, tbvae = FIT(env, tG), BVAE(env, tG)
  tfbt = FBT(env, tG, bvae=tbvae)
  for jm, tm in ((jfit, tfit), (jbvae, tbvae), (jfbt, tfbt)):
    load_flax(tm.module, jax.tree_util.tree_map(np.asarray, jm.params))
  return (jfit, jbvae, jfbt), (tfit, tbvae, tfbt), env


def test_fit_teacher_forced_equals_jax(models):
  (jfit, _, _), (tfit, _, _), env = models
  B, T = 4, 6
  batch = _batch(env, B, T)
  # the JAX script's block 1 (research/scripts/fit_diag.py:93-101)
  lcd = jnp.asarray(batch['lcd'].reshape(B, T, -1))
  logits = jfit.module.apply(jfit.params, lcd, jnp.asarray(batch['action']))
  lp = float(jdists.Bernoulli(logits).log_prob(lcd).mean())
  prob = jax.nn.sigmoid(logits)
  acc = float(((prob > 0.5) == (lcd > 0.5)).mean())
  ent = float((-prob * jnp.log(jnp.clip(prob, 1e-8))
               - (1 - prob) * jnp.log(jnp.clip(1 - prob, 1e-8))).mean())
  got = fit_diag.teacher_forced(
      tfit, {k: torch.as_tensor(v) for k, v in batch.items()})
  assert np.allclose(got, (lp, acc, ent), rtol=0, atol=1e-5), (got,
                                                               (lp, acc, ent))


@pytest.mark.parametrize('T', [6, 4], ids=['window', 'padded'])
def test_model_probe_blocks_equal_jax(models, T):
  """The three blocks on one batch: T = the window, and T below it (the
  batch zero-padded to the window)."""
  _, (_, _, tfbt), env = models
  jbvae, jfbt = models[0][1], models[0][2]
  B, W = 4, WIDTHS['window']
  batch = _batch(env, B, T, seed=T)
  bidx = model_probe.body_goal_dims(env)
  key = jax.random.PRNGKey(7)
  u = jax.random.uniform(key, (B, tfbt.z_size))   # Bernoulli.sample's draw
  got = model_probe.measure(
      tfbt, {k: torch.as_tensor(v) for k, v in batch.items()}, bidx, 0.05,
      torch.as_tensor(np.array(u)))
  # the JAX script's blocks (research/scripts/model_probe.py:76-121)
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  z = jbvae.encode(jbvae.params, jb, noise=False)
  dec = jbvae.decode(jbvae.params, z.reshape(-1, z.shape[-1]))
  err = np.asarray(dec['proprio'].mean).reshape(B * T, -1) - \
      batch['proprio'].reshape(B * T, -1)
  mad = np.abs(err[:, bidx]).mean(-1)
  i = min(W - 1, T - 1) // 2 + 1
  wb = {k: v[:, :W] for k, v in jb.items()}
  if T < W:
    wb = {k: jnp.concatenate([v, jnp.zeros((B, W - T) + v.shape[2:])], 1)
          for k, v in wb.items()}
  pred = np.asarray(jfbt.onestep(jfbt.params, dict(wb), jnp.int32(i), key,
                                 1.0)['proprio'][:, i])
  oerr = pred - batch['proprio'][:, i]
  wb_neg = dict(wb)
  wb_neg['action'] = -wb['action']
  pred_neg = np.asarray(jfbt.onestep(jfbt.params, wb_neg, jnp.int32(i), key,
                                     1.0)['proprio'][:, i])
  dpred = np.abs(pred_neg - pred)
  want = {'decode_rms': np.sqrt((err ** 2).mean(0)),
          'decode_bidx_rms': np.sqrt((err[:, bidx] ** 2).mean()),
          'decode_mad': mad, 'decode_below': (mad < 0.05).mean(),
          'onestep_rms': np.sqrt((oerr ** 2).mean(0)),
          'onestep_mad': np.abs(oerr[:, bidx]).mean(-1),
          'sensitivity': dpred.mean(0),
          'sensitivity_bidx': dpred[:, bidx].mean()}
  assert got['onestep_frame'] == i
  for k, v in want.items():
    assert np.allclose(got[k], v, rtol=0, atol=1e-5), (k, got[k], v)
  assert dpred.max() > 0         # the one-step prediction moves with a
