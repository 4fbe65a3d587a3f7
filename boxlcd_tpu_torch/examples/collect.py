"""Collect N random rollouts into a single npz (the port of
examples/collect.py): batched over --batch worlds on the device instead of
a Python loop over episodes.

    python -m boxlcd_tpu_torch.examples.collect [--env=Bounce \
        --num_eps=1000 --out=rollouts.npz --batch=250 --ep_len=50 \
        --device=cpu]
"""
import argparse

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch.data.collect import make_rollout_fn


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--env', default='Bounce')
  parser.add_argument('--num_eps', type=int, default=1000)
  parser.add_argument('--out', default='rollouts.npz')
  parser.add_argument('--batch', type=int, default=250)
  parser.add_argument('--ep_len', type=int, default=0,
                      help='steps an episode; 0: the env\'s own')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)

  G = {'ep_len': args.ep_len} if args.ep_len else None
  env = boxlcd_tpu_torch.env_map[args.env](G, device=args.device)
  fn, T = make_rollout_fn(env)
  gen = torch.Generator(device=env.device).manual_seed(0)
  chunks = []
  done = 0
  while done < args.num_eps:
    b = min(args.batch, args.num_eps - done)
    chunks.append({k: v.cpu().numpy() for k, v in fn(gen, b).items()})
    done += b
    print(f'{done}/{args.num_eps}')
  traj = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
  np.savez_compressed(args.out, **traj)
  print('saved', args.out, {k: v.shape for k, v in traj.items()})
  return traj


if __name__ == '__main__':
  main()
