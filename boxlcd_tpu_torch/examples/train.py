"""Minimal end-to-end pipeline: load rollouts, train the mini GPT, sample
(the port of examples/train.py).

    python -m boxlcd_tpu_torch.examples.train [--data=rollouts.npz \
        --env=Bounce --epochs=10 --bs=32 --lr=5e-4 --window=50 --device=cpu]
"""
import argparse

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.examples.model import Model
from boxlcd_tpu_torch.utils import AttrDict


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--env', default='Bounce')
  parser.add_argument('--data', default='rollouts.npz')
  parser.add_argument('--epochs', type=int, default=10)
  parser.add_argument('--bs', type=int, default=32)
  parser.add_argument('--lr', type=float, default=5e-4)
  parser.add_argument('--window', type=int, default=50)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)

  env = boxlcd_tpu_torch.env_map[args.env](device=args.device)
  G = AttrDict(n_embed=128, n_head=4, n_layer=2, window=args.window,
               lr=args.lr)
  model = Model(env, G)
  data = dict(np.load(args.data))
  n = data['lcd'].shape[0]
  rng = np.random.RandomState(0)
  bpd = []
  for epoch in range(args.epochs):
    order = rng.permutation(n)
    losses = []
    for i in range(0, n - args.bs + 1, args.bs):
      idx = order[i:i + args.bs]
      batch = {'lcd': data['lcd'][idx, :args.window].astype(np.float32),
               'action': data['action'][idx, :args.window]}
      m = model.train_step(batch)
      losses.append(m['bits_per_dim'])
    bpd.append(float(np.mean(losses)))
    print(f'epoch {epoch}: bits/dim {bpd[-1]:.4f}')
  samp = model.sample(torch.Generator(device=model.device).manual_seed(0), 4,
                      data['action'][:4, :args.window])
  print('sample shape', tuple(samp.shape))
  return model, bpd, samp


if __name__ == '__main__':
  main()
