"""Fiddler: latent-space sensitivity probe (the port of
research/runners/fiddler.py): perturb each proprio dim, re-encode, rank
latent dims by mean |dz|; pickles vec_weights.pkl."""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch.data.dataset import load_ds


class Fiddler:
  def __init__(self, model, env, G):
    self.model = model
    self.env = env
    self.G = G

  @torch.no_grad()
  def run(self, eps=0.2, noise=None):
    """One test batch, flattened over time, encoded without noise; then per
    proprio dim d the same batch with dim d moved by eps * N(0, 1) a frame,
    re-encoded. Writes {'sensitivity': (P, z) mean |dz|, 'weights': the
    sensitivities normalised over P} to logdir/vec_weights.pkl and returns
    the weights. `noise`, when given, is the (P, frames) standard normals;
    else they are drawn from a generator seeded with 0."""
    G = self.G
    model = self.model
    dev = model.device
    _, test_ds = load_ds(G)
    batch = next(iter(test_ds))
    flat = {k: torch.as_tensor(v.reshape(-1, *v.shape[2:]), device=dev)
            for k, v in batch.items() if k != 'action'}
    base_z = model.encode(flat, noise=False).cpu().numpy()
    N, P = flat['proprio'].shape
    if noise is None:
      gen = torch.Generator(device=dev).manual_seed(0)
      noise = torch.randn((P, N), generator=gen, device=dev)
    noise = eps * torch.as_tensor(noise, dtype=torch.float32, device=dev)
    sens = np.zeros((P, base_z.shape[-1]))
    for d in range(P):
      pert = dict(flat)
      pert['proprio'] = flat['proprio'].clone()
      pert['proprio'][:, d] += noise[d]
      z = model.encode(pert, noise=False).cpu().numpy()
      sens[d] = np.abs(z - base_z).mean(0).reshape(-1)
    weights = sens / (sens.sum(0, keepdims=True) + 1e-8)
    out = Path(G.logdir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / 'vec_weights.pkl', 'wb') as f:
      pickle.dump({'sensitivity': sens, 'weights': weights}, f)
    print('top latent dims per proprio dim:')
    for d in range(P):
      print(f'  dim {d}: {np.argsort(-sens[d])[:5].tolist()}')
    return weights
