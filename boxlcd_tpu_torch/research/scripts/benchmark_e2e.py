"""End-to-end benchmark: Urchin rollouts generated + FBT trained, the
BASELINE.json wall-clock criterion (the port of
research/scripts/benchmark_e2e.py; reference budget: README.md:89, 100k
rollouts and 100k gradient updates, under one hour).

    python -m boxlcd_tpu_torch.research.scripts.benchmark_e2e \
        [--full] [--workdir=/tmp/bench_e2e] [--device=cpu]

Phases: collection into native barrels (`data.collect.collect`: on the
card the megakernel path that fill_barrels picks), the BVAE through the
device-resident dataset (`device_dataset.train_device`), `FBT.precompute_z`
once, then the FBT on the latents. Scaled down by default (SCALED); --full
runs the real budget (FULL). Prints one JSON line with the JAX script's
keys plus the device and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import time
from pathlib import Path

import torch

from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.bench import card_line

# the module: boxlcd_tpu_torch.data exports its `collect` function by name
collect_mod = importlib.import_module('boxlcd_tpu_torch.data.collect')

# episodes, BVAE and FBT iterations, FBT (n_embed, n_head, n_layer), window,
# collection batch; reference model budgets: research/scripts/kicker.py
SCALED = dict(n_eps=2_000, bvae_iters=200, fbt_iters=200, fbt=(64, 2, 1),
              window=12, num_envs=1000, ep_len=50, bs=32)
FULL = dict(n_eps=100_000, bvae_iters=30_000, fbt_iters=100_000,
            fbt=(512, 8, 4), window=50, num_envs=4000, ep_len=50, bs=32)


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def run(work, full=False, device=None):
  """The three phases into `work`; returns the JSON record."""
  from boxlcd_tpu_torch.data.device_dataset import (
      DeviceDataset, train_device)
  from boxlcd_tpu_torch.research.define_config import config, env_fn
  from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
  from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
  device = utils.resolve_device(device)
  P = FULL if full else SCALED
  n_eps, bvae_iters, fbt_iters = P['n_eps'], P['bvae_iters'], P['fbt_iters']
  fbt_embed, fbt_head, fbt_layer = P['fbt']
  window, ep_len, bs = P['window'], P['ep_len'], P['bs']
  n_barrels = n_eps // collect_mod.BARREL_SIZE
  work = Path(work)
  t0 = time.time()

  # --- datagen --------------------------------------------------------------
  G = config()
  G.update(env='Urchin', logdir=work / 'data', ep_len=ep_len,
           train_barrels=n_barrels, test_barrels=1, num_envs=P['num_envs'],
           barrel_format='native', device=str(device))
  train = work / 'data' / 'train'
  if train.is_dir() and len(list(train.glob('*.npz'))) >= n_barrels:
    # reusing a dataset: datagen time is NOT measured this run; report it
    # as None unless the caller supplies the measured figure explicitly, so
    # composed wall-clock totals never silently mix measured and assumed
    print('[e2e] reusing existing dataset (datagen time not measured)')
    t_data = (float(os.environ['E2E_DATA_SECS'])
              if 'E2E_DATA_SECS' in os.environ else None)
    t0 = time.time() - (t_data or 0.0)
  else:
    collect_mod.collect(env_fn(G), G)
    _sync(device)
    t_data = time.time() - t0

  # --- BVAE (device-resident dataset: no host round-trips a step) ------------
  ds = DeviceDataset(train, device=device)
  print(f'[e2e] dataset on device: {ds.n_episodes} episodes')
  G2 = config()
  G2.update(env='Urchin', datadir=work / 'data', logdir=work / 'bvae',
            total_itr=bvae_iters, bs=bs, window=5, hidden_size=64,
            nfilter=16, vqD=16, vqK=64, ep_len=ep_len, lr=5e-4,
            device=str(device))
  bvae = BVAE(env_fn(G2)(), G2)
  train_device(bvae, ds, bvae_iters, bs=bs, window=5,
               chunk=min(200, bvae_iters),
               log_every=max(1, bvae_iters // 4))
  bvae.save(work / 'bvae')
  _sync(device)
  t_bvae = time.time() - t0 - (t_data or 0.0)

  # --- FBT ------------------------------------------------------------------
  G3 = config()
  G3.update(env='Urchin', datadir=work / 'data', weightdir=work / 'bvae',
            logdir=work / 'fbt', total_itr=fbt_iters, bs=bs, window=window,
            n_embed=fbt_embed, n_head=fbt_head, n_layer=fbt_layer,
            hidden_size=64, nfilter=16, vqD=16, vqK=64, ep_len=ep_len,
            lr=5e-4, device=str(device))
  fbt = FBT(env_fn(G3)(), G3)
  # encode the dataset through the frozen BVAE once; FBT trains on latents
  # directly instead of re-encoding bs*window frames every iteration
  t_enc = time.time()
  zdata = {'z': fbt.precompute_z(ds.data, unpack=ds.unpack_lcd),
           'action': ds.data['action']}
  _sync(device)
  print(f'[e2e] latents precomputed in {time.time() - t_enc:.1f}s')
  train_device(fbt, ds, fbt_iters, bs=bs, window=window,
               chunk=min(100, fbt_iters), log_every=max(1, fbt_iters // 4),
               data=zdata)
  fbt.save(work / 'fbt')
  _sync(device)
  total = time.time() - t0

  rec = {
      'metric': 'e2e_datagen_plus_fbt_wallclock',
      'n_episodes': n_eps, 'bvae_iters': bvae_iters, 'fbt_iters': fbt_iters,
      'datagen_s': None if t_data is None else round(t_data, 1),
      'bvae_s': round(t_bvae, 1),
      'total_s': None if t_data is None else round(total, 1),
      'measured_this_run_s': round(total - (t_data or 0.0), 1),
      'under_one_hour': None if t_data is None else total < 3600,
      'device': str(device), 'card': card_line(device),
  }
  print(json.dumps(rec), flush=True)
  return rec


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--full', action='store_true')
  parser.add_argument('--workdir', default='/tmp/bench_e2e')
  parser.add_argument('--device', default=None)
  args = parser.parse_args(argv)
  return run(args.workdir, args.full, args.device)


if __name__ == '__main__':
  main()
