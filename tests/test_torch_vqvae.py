"""The VQVAE's early training at its default widths (hidden 128, nfilter
64, vqD 128, vqK 128), in the JAX package and in the port from the same
converted parameters on the same batches: the codebook term of the loss
climbs by two orders of magnitude within a dozen steps in both (the
encoder's outputs leave the codebook, initialised in [0, 2/K)), and the
two packages' losses agree step by step. This is why chip_smoke.py's
phase 13 gates the VQVAE's training on its frame loss, not its total.

Tolerance: each step's losses within 1e-3 relative (12 Adam steps in
float32 from equal parameters).
"""
import jax
import numpy as np
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders import VQVAE
from boxlcd_tpu_torch.research.nets.convert import load_flax
from research.define_config import config as jconfig
from research.nets.autoencoders.vqvae import VQVAE as JVQVAE

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

STEPS = 12


def batches(env, n, bs=8, T=5, seed=0):
  """Frames with one 4x4 block each, random proprio."""
  rng = np.random.RandomState(seed)
  for _ in range(n):
    lcd = np.zeros((bs, T, env.lcd_h, env.lcd_w), np.float32)
    for b in range(bs):
      x, y = rng.randint(0, env.lcd_w - 4), rng.randint(0, env.lcd_h - 4)
      lcd[b, :, y:y + 4, x:x + 4] = 1
    yield {'lcd': lcd,
           'proprio': rng.uniform(-1, 1, (bs, T, env.pobs_size)
                                  ).astype(np.float32),
           'action': np.zeros((bs, T, env.act_size), np.float32)}


def test_codebook_term_climbs_alike_in_both_packages():
  jenv = boxlcd_tpu.env_map['Urchin']()
  env = boxlcd_tpu_torch.env_map['Urchin'](device='cpu')
  kw = dict(wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base, window=5,
            bs=8, lr=5e-4)                   # kicker.py's lr
  jG, tG = jconfig(), tconfig()
  jG.update(kw)
  tG.update(kw, device='cpu')
  jm, tm = JVQVAE(jenv, jG), VQVAE(env, tG)
  load_flax(tm.module, jax.tree_util.tree_map(np.asarray, jm.params))
  jvq, tvq = [], []
  for batch in batches(env, STEPS):
    jmet, tmet = jm.train_step(batch), tm.train_step(batch)
    for k in ('loss/total', 'loss/vq', 'loss/recon_lcd'):
      np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-3)
    jvq.append(float(jmet['loss/vq']))
    tvq.append(float(tmet['loss/vq']))
  assert jvq[-1] > 100 * jvq[0] and tvq[-1] > 100 * tvq[0], (jvq, tvq)
  assert float(tmet['loss/recon_lcd']) < 0.6   # the frames still train
