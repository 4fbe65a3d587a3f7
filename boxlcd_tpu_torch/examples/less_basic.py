"""Interactive env driver (the port of examples/less_basic.py).

With pyglet + a display: a live window with the reference's key bindings —
  0      reset env            SPACE  pause (RIGHT single-steps while paused)
  1      toggle reset-on-done O      toggle obs printing
  S / F  slower / faster      P      toggle matplotlib frame plotting
  ESC    quit
Without a display: scripted actions, and the rollout written as a gif, so
the example always runs.

    python -m boxlcd_tpu_torch.examples.less_basic [--env=Luxo --steps=100 \
        --out=less_basic.gif --headless=1 --device=cpu]
"""
import argparse
import time

import numpy as np

import boxlcd_tpu_torch


def run_headless(env, args):
  from boxlcd_tpu_torch.research.utils import write_gif
  if args.actions:
    acts = np.load(args.actions)
  else:
    t = np.arange(args.steps)[:, None]
    phase = np.arange(env.act_size)[None, :]
    acts = np.sin(0.3 * t + 2.0 * phase).astype(np.float32)
  frames = []
  for i in range(args.steps):
    obs, rew, done, info = env.step(acts[i % len(acts)])
    frames.append(1.0 - obs['lcd'])
  path = write_gif(args.out, np.stack(frames))
  print('wrote', path)
  return path


def run_interactive(env, args):
  import pyglet
  KEY = pyglet.window.key
  env.render('human')  # creates env.viewer
  handler = KEY.KeyStateHandler()
  env.viewer.window.push_handlers(handler)
  paused = False
  reset_on_done = True
  obs_log = False
  plotting = False
  delay = 1.0 / (2 * env.G.fps)
  past = {}
  ret = 0.0
  while True:
    cur = dict(handler)

    def check(k):
      return cur.get(k, False) and not past.get(k, False)
    if check(KEY._0) or check(KEY.NUM_0):
      env.reset()
    if check(KEY.SPACE):
      paused = not paused
    if check(KEY.O):
      obs_log = not obs_log
    if check(KEY.P):
      plotting = not plotting
    if check(KEY._1):
      reset_on_done = not reset_on_done
    if check(KEY.ESCAPE):
      return
    if check(KEY.S):
      delay *= 2
    if check(KEY.F):
      delay /= 2
    if not paused or check(KEY.RIGHT):
      obs, rew, done, info = env.step(env.action_space.sample())
      ret += rew
      if obs_log:
        print({k: np.round(v, 3) for k, v in obs.items() if k != 'lcd'})
      if done and reset_on_done:
        print('episode return', ret)
        ret = 0.0
        env.reset()
    img = env.render('human')
    if plotting:
      import matplotlib.pyplot as plt
      plt.imshow(img)
      plt.show()
    time.sleep(delay)
    past = cur


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--env', default='Luxo')
  parser.add_argument('--steps', type=int, default=100)
  parser.add_argument('--actions', default='',
                      help='npy file of (T, act_size) actions; default sine '
                           'sweep (headless mode only)')
  parser.add_argument('--out', default='less_basic.gif')
  parser.add_argument('--headless', type=int, default=-1,
                      help='1 forces the scripted gif path; default: '
                           'interactive when a pyglet window can open')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)

  env = boxlcd_tpu_torch.env_map[args.env](device=args.device)
  env.seed(0)
  env.reset()
  from boxlcd_tpu_torch.viewer import HAVE_PYGLET
  interactive = HAVE_PYGLET if args.headless == -1 else not args.headless
  if interactive:
    try:
      run_interactive(env, args)
      return None
    except Exception as e:  # no display, etc.
      print(f'interactive viewer unavailable ({e}); falling back headless')
  return run_headless(env, args)


if __name__ == '__main__':
  main()
