"""Vizer: model-vs-truth rollout visualization (the port of
research/runners/vizer.py; reference: research/runners/vizer.py).

Two modes: `Vizer` is the headless replay that writes side-by-side
comparison media; `InteractiveVizer` (`--interactive=1`) is the live pyglet
keyboard debugger matching the reference's vizer.py:81-309 (model-vs-truth
stepping, on-demand sampling, weight reload and goal dragging), and falls
back to the headless replay when pyglet or a display is unavailable.

The truth rollouts step the functional `Env.step` one step at a time (a
Python loop where the JAX package scans), so every truth frame goes through
`raster.lcd_render`. JAX's keys become generators on the model's device;
`run`, `optimize_actions` and `AutoEnv.step` also take the draws they
would make (reset states, actions, the samplers' uniforms) as arguments,
so a caller can feed them.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research.nets import dists


def write_gif(path, frames, fps=10):
  """frames: (T, H, W) float/bool -> animated gif via PIL, at the frames'
  own size; `<path>.npz` where Pillow is not installed. Returns the path
  written."""
  try:
    from PIL import Image
  except ImportError:
    np.savez_compressed(str(path) + '.npz', frames=np.asarray(frames))
    return str(path) + '.npz'
  imgs = [Image.fromarray((255 * np.asarray(f, np.float32)).astype(np.uint8))
          for f in frames]
  imgs[0].save(str(path), save_all=True, append_images=imgs[1:],
               duration=int(1000 / fps), loop=0)
  return str(path)


def _raw(env):
  """The bare env under a goal wrapper."""
  return env._env if hasattr(env, '_env') else env


def truth_rollout(raw, state, actions):
  """Step `raw`'s functional core from a batch-of-one `state` through
  `actions` (T, act); returns {'lcd': (T, H, W) bool, 'proprio': (T, P),
  'full_state': (T, obs)} tensors on the env's device, one frame a step."""
  obs = []
  for a in actions:
    state, o, *_ = Env.step(raw, state, a[None])
    obs.append(o)
  return {k: torch.cat([o[k] for o in obs]) for k in obs[0]}


def _host(x):
  return x.detach().float().cpu().numpy()


class Vizer:
  def __init__(self, model, env, G):
    self.model = model
    self.env = env
    self.G = G

  def optimize_actions(self, gen, actions, prompts, goal_lcd, iters=10,
                       lr=1.0, u=None):
    """Plan an action sequence by gradient descent THROUGH the model toward
    a goal frame (reference: vizer.py:149-170): roll out with the current
    actions, backprop the goal-frame log-likelihood into the action
    conditioning (the rolled-out frames are constants, as in the
    reference), zero the prompt-action grads, step, clamp to [-1, 1].

    Only the actions take a gradient: the rollout and the BVAE's encodes
    run without one, and the model's parameters collect none. `u`, when
    given, holds each iteration's sampler uniforms (a list of `iters`);
    else the sampler draws from `gen`.

    Returns (optimized_actions, initial_loss, final_loss)."""
    model = self.model
    dev = model.device
    prompt_n = self.G.prompt_n
    goal = torch.as_tensor(np.asarray(goal_lcd, np.float32),
                           device=dev)[None]                   # (1, H, W)

    if model.name == 'FBT':
      with torch.no_grad():
        gz = model.bvae.encode(
            {'lcd': goal,
             'proprio': torch.zeros((1, model.proprio_n), device=dev)},
            noise=False)

      def loss_fn(a, lcd, proprio):
        with torch.no_grad():
          z = model.bvae.encode({'lcd': lcd, 'proprio': proprio},
                                noise=False)
        logits = model.module(z, a)
        return -dists.Bernoulli(logits[:, -1]).log_prob(gz).mean()
    else:  # pixel-token models (FIT)
      gflat = goal.reshape(1, -1)

      def loss_fn(a, lcd, proprio):
        T = lcd.shape[1]
        logits = model.module(lcd.reshape(1, T, -1), a)
        return -dists.Bernoulli(logits[:, -1]).log_prob(gflat).mean()

    a = torch.as_tensor(actions, dtype=torch.float32, device=dev)
    loss0 = loss = None
    for it in range(iters):
      roll = model.sample(gen, 1, action=a, prompts=prompts,
                          prompt_n=prompt_n, u=None if u is None else u[it])
      lcd = roll['lcd'].reshape(1, -1, *goal.shape[-2:]).float()
      a = a.detach().requires_grad_(True)
      loss = loss_fn(a, lcd, roll['proprio'])
      (g,) = torch.autograd.grad(loss, [a])
      if loss0 is None:
        loss0 = float(loss.detach())
      g[:, :prompt_n] = 0.0
      a = torch.clamp(a.detach() - lr * g, -1, 1)
    return a, loss0, float(loss.detach())

  def run(self, n_rollouts=4, draws=None):
    """Per rollout: a truth rollout of block_size random-action steps, the
    model's sample prompted by its first prompt_n frames on the same
    actions, and a truth-over-sample gif; with G.optimize_actions, the
    actions planned toward the last truth frame and a before-over-after
    gif (reference: vizer.py:91-135).

    `draws`, when given, is a list with one dict a rollout holding what it
    would draw: 'state' (the reset, a batch-of-one WorldState), 'actions'
    (T, act), 'u' (the sample's uniforms), and for optimize_actions 'opt_u'
    (a list, one an iteration), 'u_before' and 'u_after'; what is missing
    is drawn from a generator seeded with G.seed. Returns one dict a
    rollout: the truth, sample, before and after frames (numpy), the
    losses, the planned actions and the paths written."""
    G = self.G
    logdir = Path(G.logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    raw = _raw(self.env)
    model = self.model
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(int(G.seed))
    T = model.block_size
    out = []
    for r in range(n_rollouts):
      d = draws[r] if draws is not None else {}
      state = d.get('state')
      if state is None:
        state = Env.reset(raw, gen, 1)
      actions = d.get('actions')
      if actions is None:
        actions = torch.rand((T, raw.act_size), generator=gen,
                             device=dev) * 2 - 1
      actions = torch.as_tensor(actions, dtype=torch.float32, device=dev)
      truth = truth_rollout(raw, state, actions)
      # model rollout prompted by the first prompt_n frames
      prompts = {k: v[None].float() for k, v in truth.items()
                 if k != 'full_state'}
      sample = model.sample(gen, 1, action=actions[None], prompts=prompts,
                            prompt_n=G.prompt_n, u=d.get('u'))
      t_lcd = _host(truth['lcd'])
      p_lcd = _host(sample['lcd'][0]).reshape(t_lcd.shape)
      strip = np.concatenate([t_lcd, p_lcd], axis=1)  # truth on top
      rec = dict(truth=t_lcd, sample=p_lcd,
                 gif=write_gif(logdir / f'viz_rollout_{r}.gif', strip))
      print('wrote', rec['gif'])
      if G.get('optimize_actions', 0):
        # plan through the model toward the truth rollout's final frame
        opt_a, l0, l1 = self.optimize_actions(
            gen, actions[None], prompts, t_lcd[-1], u=d.get('opt_u'))
        print(f'optimize_actions rollout {r}: loss {l0:.4f} -> {l1:.4f}')
        before = model.sample(gen, 1, action=actions[None], prompts=prompts,
                              prompt_n=G.prompt_n, u=d.get('u_before'))
        after = model.sample(gen, 1, action=opt_a, prompts=prompts,
                             prompt_n=G.prompt_n, u=d.get('u_after'))
        b_lcd = _host(before['lcd'][0]).reshape(t_lcd.shape)
        a_lcd = _host(after['lcd'][0]).reshape(t_lcd.shape)
        strip = np.concatenate([b_lcd, a_lcd], axis=1)  # before over after
        rec.update(loss0=l0, loss1=l1, actions=opt_a, before=b_lcd,
                   after=a_lcd, opt_gif=write_gif(
                       logdir / f'viz_optimized_{r}.gif', strip))
        print('wrote', rec['opt_gif'])
      out.append(rec)
    return out


def outproc(img):
  """(H, W) float/bool frame -> 8x-upscaled RGB uint8 (reference:
  vizer.py:19-20)."""
  img = np.asarray(img, np.float32)
  return (255 * img[..., None].repeat(3, -1)
          .repeat(8, -2).repeat(8, -3)).astype(np.uint8)


class AutoEnv:
  """Live model-vs-truth stepper (reference: vizer.py:22-80): the real env
  and the learned model advance in lockstep from a shared action stream;
  the model serves each frame through `onestep` on a sliding window."""

  def __init__(self, model, env, G):
    self.env = env  # stateful WorldEnv (or goal wrapper around it)
    self.G = G
    self.model = model
    self.gen = torch.Generator(device=model.device).manual_seed(
        int(G.get('seed', 0)))
    self.window_batch = None
    self.tot_count = 0

  def reset(self):
    self.tot_count = 0
    obs = self.env.reset()
    self.goal_lcd = obs.get('goal:lcd')
    self.goal_proprio = obs.get('goal:proprio')
    obses = {k: [v] for k, v in obs.items() if not k.startswith('goal:')}
    acts = []
    # prime the window with up to 10 real frames (vizer.py:38; capped so
    # small windows still leave one slot to predict into)
    for _ in range(min(9, self.G.window - 2)):
      act = self.env.action_space.sample()
      obs = self.env.step(act)[0]
      for k in obses:
        obses[k].append(obs[k])
      acts.append(act)
    batch = {k: np.stack(v, 0)[None].astype(np.float32)
             for k, v in obses.items()}
    batch['action'] = np.stack(acts + [np.zeros_like(acts[0])], 0)[None]
    self.count = batch['lcd'].shape[1] - 1
    for k, v in batch.items():  # zero-pad out to the model window
      pad = np.zeros([1, self.G.window - v.shape[1], *v.shape[2:]], v.dtype)
      batch[k] = np.concatenate([v, pad], 1)
    self.window_batch = batch
    img = outproc(batch['lcd'][0, self.count])
    goal = outproc(self.goal_lcd) if self.goal_lcd is not None else None
    return img, img, goal

  def step(self, act, gen=None, u=None):
    """One lockstep: the real env takes `act`, the model predicts the same
    frame with `onestep` at temperature 0.1, reading uniforms `u` when
    given, else drawing from `gen` (default: this AutoEnv's generator)."""
    self.tot_count += 1
    obs, rew, done, info = self.env.step(act)
    truth = obs['lcd']
    self.window_batch['action'][:, self.count] = np.asarray(act)[None]
    dev = self.model.device
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in self.window_batch.items()}
    batch = self.model.onestep(batch, self.count, gen or self.gen, temp=0.1,
                               u=u)
    self.window_batch = {k: v.cpu().numpy() for k, v in batch.items()}
    pred = self.window_batch['lcd'][0, self.count]
    if self.count == self.G.window - 2:  # slide the window (vizer.py:71-73)
      self.window_batch = {k: np.concatenate([v[:, 1:], v[:, :1]], axis=1)
                           for k, v in self.window_batch.items()}
    self.count = min(1 + self.count, self.G.window - 2)
    lrew = None
    if self.goal_proprio is not None and hasattr(self.env, 'comp_rew_done'):
      proprio = self.window_batch['proprio'][0, self.count - 1]
      lrew, _ = self.env.comp_rew_done(
          {'proprio': proprio, 'goal:proprio': self.goal_proprio})
    goal = outproc(self.goal_lcd) if self.goal_lcd is not None else None
    return outproc(truth), outproc(pred), rew, lrew, goal


class InteractiveVizer(Vizer):
  """Live pyglet keyboard debugger (reference: vizer.py:81-309).

  Keys (reference on_key_press, vizer.py:98-118):
    SPACE  pause/resume the live model-vs-truth stepping
    S      sample model rollouts vs truth, shown as looping filmstrips
    0      reset the episode
    R      reload model weights from weightdir
    G      goal mode — LEFT/RIGHT drag the goal bodies in x, SPACE returns
    ESC    quit
  Without pyglet or a display, `run` is the headless `Vizer.run`.
  """

  def __init__(self, model, env, G):
    super().__init__(model, env, G)
    from boxlcd_tpu_torch.viewer import HAVE_PYGLET
    self.have_window = False
    if HAVE_PYGLET:
      try:
        import pyglet
        self.pyglet = pyglet
        self.KEY = pyglet.window.key
        self.window = pyglet.window.Window(1280, 720)
        self.have_window = True
      except Exception as e:  # headless machine: no GL context
        print(f'pyglet window unavailable ({e}); headless replay instead')
    else:
      print('pyglet not installed; headless replay instead')
    if not self.have_window:
      return
    self.autoenv = AutoEnv(model, env, G)
    self.paused = False
    self.held_down = {}
    self.messages = {}

    def on_key_press(symbol, modifiers):
      K = self.KEY
      if symbol == K.SPACE:
        self.paused = not self.paused
      if symbol == K.ESCAPE:
        self.closed = True
      if symbol == K.S:
        self.messages['sample'] = 1
      if symbol in (K._0, K.NUM_0):
        self.messages['reset'] = 1
      if symbol == K.R:
        print('RELOAD WEIGHTS')
        self.model.load(self.G.weightdir)
      if symbol == K.G:
        self.messages['goal'] = 1
      self.held_down[symbol] = 1

    def on_key_release(symbol, modifiers):
      self.held_down[symbol] = 0

    self.window.set_handlers(on_key_press=on_key_press,
                             on_key_release=on_key_release)
    self.closed = False

  def check_message(self, name):
    if self.messages.get(name):
      self.messages[name] = 0
      return True
    return False

  def draw(self, imgs=(), texts=()):
    """Blit (cell_xy, rgb) tiles into the window (reference:
    vizer.py:283-309); cell units are one upscaled LCD frame."""
    pyglet = self.pyglet
    cell = np.array([self.G.lcd_base * self.G.wh_ratio,
                     self.G.lcd_base]) * 8
    self.window.clear()
    self.window.switch_to()
    self.window.dispatch_events()
    for xy, img in imgs:
      img = np.ascontiguousarray(img, np.uint8)
      data = pyglet.image.ImageData(img.shape[1], img.shape[0], 'RGB',
                                    img.tobytes(), pitch=img.shape[1] * -3)
      data.blit(*(np.array(xy) * cell))
    for xy, text in texts:
      xy = np.array(xy) * cell
      pyglet.text.Label(text, x=xy[0], y=xy[1], anchor_x='center',
                        anchor_y='center').draw()
    self.window.flip()

  def sample_strips(self, gen, n=4):
    """Fresh truth rollout + n model rollouts on the same actions
    (reference: vizer.py:249-277)."""
    raw = _raw(self.env)
    model = self.model
    dev = model.device
    T = model.block_size
    state = Env.reset(raw, gen, 1)
    actions = torch.rand((T, raw.act_size), generator=gen,
                         device=dev) * 2 - 1
    t_lcd = truth_rollout(raw, state, actions)['lcd'].float()
    strips = [_host(t_lcd)]
    prompts = {'lcd': t_lcd[None],
               'proprio': torch.zeros((1, T, raw.pobs_size), device=dev)}
    for _ in range(n):
      s = model.sample(gen, 1, action=actions[None], prompts=prompts,
                       prompt_n=5)
      strips.append(_host(s['lcd'][0]).reshape(strips[0].shape))
    return [np.stack([outproc(f) for f in strip]) for strip in strips]

  def do_goal(self):
    """Goal dragging (reference: vizer.py:173-207): hold LEFT/RIGHT to slide
    the goal bodies in x (via teleport reset), SPACE to exit goal mode."""
    raw = _raw(self.env)
    eobs = raw.reset()
    xkeys = utils.filtlist(raw.obs_keys, '.*x:p')
    K = self.KEY
    while not self.closed:
      neobs = utils.NamedArray(eobs['full_state'].copy(), raw.obs_info,
                               do_map=False)
      if self.held_down.get(K.LEFT):
        neobs[xkeys] = neobs[xkeys] - 0.05
      if self.held_down.get(K.RIGHT):
        neobs[xkeys] = neobs[xkeys] + 0.05
      eobs = raw.reset(full_state=neobs.arr)
      goal_lcd = raw.lcd_render()
      self.draw(imgs=[((1, 1), outproc(goal_lcd))],
                texts=[((2, 3), 'goal mode: LEFT/RIGHT drag, SPACE exit')])
      if self.held_down.get(K.SPACE):
        self.held_down[K.SPACE] = 0
        self.paused = False
        return

  def run(self, n_rollouts=4, draws=None):
    if not self.have_window:
      return super().run(n_rollouts, draws)
    gen = torch.Generator(device=self.model.device).manual_seed(
        int(self.G.seed))
    atruth, apred, goal = self.autoenv.reset()
    rew, lrew, i, strips = 0.0, None, 0, []
    while not self.closed:
      imgs = []
      if self.check_message('sample'):
        strips = self.sample_strips(gen)
      if strips:
        j = i % len(strips[0])
        imgs += [((2 * si, 0), strip[j]) for si, strip in enumerate(strips)]
      imgs += [((0, 2), atruth), ((0, 1), apred)]
      if goal is not None:
        imgs.append(((0, 3), goal))
      texts = [((0.5, 1.8), f'pred rew {lrew:.3f}' if lrew is not None
                else 'pred'), ((0.5, 2.8), f'truth rew {rew:.3f}')]
      if not self.paused:
        atruth, apred, rew, lrew, goal = self.autoenv.step(
            self.env.action_space.sample(), gen)
        i += 1
      if self.check_message('reset'):
        atruth, apred, goal = self.autoenv.reset()
      if self.check_message('goal'):
        self.do_goal()
      self.draw(imgs=imgs, texts=texts)
      time.sleep(0.01)
    self.window.close()
    return []
