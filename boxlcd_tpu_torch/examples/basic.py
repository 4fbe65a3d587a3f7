"""Run an env and print LCD frames (the port of examples/basic.py).

    python -m boxlcd_tpu_torch.examples.basic [--env=Bounce --steps=50 \
        --device=cpu]
"""
import argparse

import numpy as np

import boxlcd_tpu_torch


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--env', default='Bounce')
  parser.add_argument('--steps', type=int, default=50)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  env = boxlcd_tpu_torch.env_map[args.env](device=args.device)
  env.seed(0)
  obs = env.reset()
  printed = {}
  for t in range(args.steps):
    action = env.action_space.sample()
    obs, rew, done, info = env.step(action)
    if t % 10 == 0:
      frame = np.asarray(1 - obs['lcd'], int)
      printed[t] = frame
      print(f'--- t={t}')
      print('\n'.join(''.join('#' if v else '.' for v in row)
                      for row in frame))
  return printed


if __name__ == '__main__':
  main()
