"""Evaluation metrics in torch: SSIM, PSNR, FID (Frechet), precision/recall.

The port of research/metrics.py: SSIM/PSNR as tensor math, FID on the host
in float64 numpy with an eigh-based PSD matrix square root (as the JAX
`_sqrtm_psd`), manifold precision/recall (arXiv 1904.06991) from matmul-form
pairwise distances.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size=11, sigma=1.5):
  x = torch.arange(size, dtype=torch.float32) - size // 2
  g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
  g = g / g.sum()
  return torch.outer(g, g)


def ssim(pred, target, data_range=1.0, ksize=11, sigma=1.5):
  """Mean SSIM over a batch; inputs (B, C, H, W) or (B, H, W)."""
  if pred.dim() == 3:
    pred, target = pred[:, None], target[:, None]
  pred, target = pred.float(), target.float()
  kernel = _gaussian_kernel(ksize, sigma).to(pred.device)[None, None]
  B, C, H, W = pred.shape

  def filt(x):
    y = F.conv2d(x.reshape(B * C, 1, H, W), kernel)
    return y.reshape(B, C, *y.shape[2:])

  c1 = (0.01 * data_range) ** 2
  c2 = (0.03 * data_range) ** 2
  mu_p, mu_t = filt(pred), filt(target)
  mu_p2, mu_t2, mu_pt = mu_p ** 2, mu_t ** 2, mu_p * mu_t
  s_p = filt(pred * pred) - mu_p2
  s_t = filt(target * target) - mu_t2
  s_pt = filt(pred * target) - mu_pt
  num = (2 * mu_pt + c1) * (2 * s_pt + c2)
  den = (mu_p2 + mu_t2 + c1) * (s_p + s_t + c2)
  return (num / den).mean()


def psnr(pred, target, data_range=1.0):
  mse = ((pred.float() - target.float()) ** 2).mean()
  return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-10))


def _sqrtm_psd(mat):
  """Matrix square root of a PSD matrix via eigendecomposition (numpy)."""
  w, v = np.linalg.eigh(mat)
  w = np.maximum(w, 0.0)
  return (v * np.sqrt(w)[None]) @ v.T


def fid(feats_a, feats_b):
  """Frechet distance between two feature sets (B, D), on the host in
  float64 (the "FVD" number when feats come from a temporal arbiter). As in
  the JAX package, the mean-difference term is the standard .sum()."""
  feats_a = np.asarray(_numpy(feats_a), np.float64)
  feats_b = np.asarray(_numpy(feats_b), np.float64)
  mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
  ca = np.cov(feats_a, rowvar=False)
  cb = np.cov(feats_b, rowvar=False)
  rb = _sqrtm_psd(cb)
  csqrt = _sqrtm_psd(rb @ ca @ rb)
  val = ((mu_a - mu_b) ** 2).sum() + np.trace(ca + cb - 2 * csqrt)
  return np.maximum(val, 0.0)


def _numpy(x):
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def precision_recall_f1(real_feats, fake_feats, k=3):
  """Manifold precision/recall (arXiv 1904.06991; reference: utils.py:288-314).

  A fake sample counts as precise if it lies within the k-NN radius of some
  real sample (and vice versa for recall). Pairwise distances use the
  |a|^2 + |b|^2 - 2ab^T identity, which peaks at the (N, N) matrix rather
  than an (N, N, D) broadcast.
  """
  real = torch.as_tensor(real_feats).float()
  fake = torch.as_tensor(fake_feats).float()

  def pdist2(a, b):
    d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None] - 2.0 * (a @ b.T)
    return torch.clamp(d2, min=0.0)

  def knn_radius(x):
    # k+1 smallest (0th is self): distance to the k-th neighbour
    return torch.sqrt(torch.topk(pdist2(x, x), k + 1, largest=False)[0][:, k])

  def coverage(points, manifold, radii):
    return (pdist2(points, manifold) <= radii[None] ** 2).any(1).float().mean()

  precision = coverage(fake, real, knn_radius(real))
  recall = coverage(real, fake, knn_radius(fake))
  f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-8)
  return {'precision': precision, 'recall': recall, 'f1': f1}
