"""The port's evaluation metrics (boxlcd_tpu_torch/research/metrics.py)
against research/metrics.py on the same numpy-seeded inputs, and the
checks tests/test_models.py:113 makes of the JAX ones.

Tolerance: SSIM and PSNR 1e-5 absolute (float32); FID 1e-9 relative (both
run the same float64 numpy); precision/recall/F1 within 1e-7, as they are
fractions of counts (equal unless a distance sits on a k-NN radius).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxlcd_tpu_torch.research import metrics as M
from research import metrics as JM

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


@pytest.mark.parametrize('shape', [(4, 16, 16), (3, 2, 16, 32)])
def test_ssim_psnr(shape):
  rng = np.random.RandomState(0)
  a = (rng.rand(*shape) > 0.5).astype(np.float32)
  b = np.where(rng.rand(*shape) > 0.9, 1 - a, a).astype(np.float32)
  for x, y in ((a, b), (a, a)):
    assert abs(float(M.ssim(torch.as_tensor(x), torch.as_tensor(y)))
               - float(JM.ssim(jnp.asarray(x), jnp.asarray(y)))) < 1e-5
    assert abs(float(M.psnr(torch.as_tensor(x), torch.as_tensor(y)))
               - float(JM.psnr(jnp.asarray(x), jnp.asarray(y)))) < 1e-5
  assert float(M.ssim(torch.as_tensor(a), torch.as_tensor(a))) > 0.99
  assert float(M.psnr(torch.as_tensor(a), torch.as_tensor(a))) > 50


def test_fid():
  f1 = np.random.RandomState(1).randn(64, 8).astype(np.float32)
  f2 = (f1 + np.random.RandomState(2).randn(64, 8) * 0.3).astype(np.float32)
  for a, b in ((f1, f2), (f1, f1 + 0.01)):
    ours = float(M.fid(torch.as_tensor(a), torch.as_tensor(b)))
    ref = float(JM.fid(a, b))
    assert abs(ours - ref) <= 1e-9 * max(1.0, abs(ref)), (ours, ref)
  assert float(M.fid(f1, f1 + 0.01)) < 0.1


def test_precision_recall_f1():
  real = np.random.RandomState(2).randn(64, 8).astype(np.float32)
  fake = real + (np.random.RandomState(3).randn(64, 8) * 0.5
                 ).astype(np.float32)
  for k in (1, 3):
    got = M.precision_recall_f1(torch.as_tensor(real), torch.as_tensor(fake),
                                k=k)
    want = JM.precision_recall_f1(jnp.asarray(real), jnp.asarray(fake), k=k)
    for key in ('precision', 'recall', 'f1'):
      assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-7)
  # and against the naive broadcast form (tests/test_models.py:113)
  k = 3
  d = lambda x, y: np.linalg.norm(x[:, None] - y[None], axis=-1)
  r_real = np.sort(d(real, real), 1)[:, k]
  r_fake = np.sort(d(fake, fake), 1)[:, k]
  prec = (d(fake, real) <= r_real[None]).any(1).mean()
  rec = (d(real, fake) <= r_fake[None]).any(1).mean()
  got = M.precision_recall_f1(torch.as_tensor(real), torch.as_tensor(fake))
  assert abs(float(got['precision']) - prec) < 1e-5
  assert abs(float(got['recall']) - rec) < 1e-5
  assert float(M.precision_recall_f1(real, real)['f1']) > 0.9
