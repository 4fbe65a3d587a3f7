"""LearnedEnv / RewardLenv: the world model served as a batched environment
(the port of research/wrappers/learned_env.py).

RL agents act inside the learned simulator. A window of (lcd, proprio,
action), each (B, window, ...), lives on the model's device; each step
writes the action before the pointer, runs the model's `onestep` to
predict the frame at the pointer, and slides the window when it is full
(JAX: learned_env.py:89-105). RewardLenv adds goals and rewards:
proprio-delta body goals, or cube goals through a frozen ObjectLocalizer
(:125-245).

The real env is touched only at resets: the prompts and the goals each come
from one batched `Env.reset` + `Env.observe` (one lcd raster launch on the
card). Observations, rewards and dones stay tensors on the device. The RL
keys the env reads (`goal_thresh`, `lenv_temp`, `reset_prompt`,
`lenv_goals`, `diff_delt`) belong to the RL entry point's config; `G.get`
reads them with its defaults.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch import spaces, utils
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research.nets.video_models._base import uniform_actions

# the RL config's defaults (the JAX package's research/rl/main.py rl_config)
RL_DEFAULTS = {'goal_thresh': 0.05, 'lenv_temp': 1.0, 'reset_prompt': 1,
               'lenv_goals': 0, 'diff_delt': 0}
GOAL_SEED = 17          # RewardLenv's own goal stream (the JAX PRNGKey(17))
WARMUP, SHIFT = 10, 5   # reset_prompt=0: model steps, then frames dropped


def _rl(G, key):
  return G.get(key, RL_DEFAULTS[key])


def _slide(wb, k):
  """Every window tensor shifted left by k positions, zeros after."""
  return {key: torch.cat([v[:, k:], torch.zeros_like(v[:, :k])], 1)
          for key, v in wb.items()}


class LearnedEnv:
  def __init__(self, num_envs, model, G, real_env=None):
    self.num_envs = num_envs
    self.G = G
    self.model = model
    self.device = model.device
    self.real_env = real_env if real_env is not None else model.env
    base = self.real_env
    # unwrap goal wrappers to the raw env for key metadata
    raw = base._env if hasattr(base, '_env') else base
    self.obs_keys = raw.obs_keys
    self.pobs_keys = raw.pobs_keys
    self.raw_env = raw
    self.window = model.G.window
    self.keys = ['lcd', 'proprio']
    lcd_space = raw.observation_space['lcd']
    pro_space = raw.observation_space['proprio']
    self.observation_space = spaces.Dict({
        'lcd': spaces.Box(-1, 1, (num_envs,) + lcd_space.shape, np.float32),
        'proprio': spaces.Box(-1, 1, (num_envs,) + pro_space.shape,
                              np.float32),
    })
    self.action_space = spaces.Box(-1, 1, (num_envs, raw.act_size),
                                   np.float32)
    self.gen = torch.Generator(device=self.device)
    self.gen.manual_seed(int(G.get('seed', 0)))

  def real_obs(self, gen, n):
    """The first observations of n fresh real episodes: one batched reset
    and observe (JAX: learned_env.py:51-53, a vmap there)."""
    raw = self.raw_env
    return Env.observe(raw, Env.reset(raw, gen, n))

  def reset(self, update_window_batch=True):
    """Prompt from real env resets (JAX: learned_env.py:59-87)."""
    B, W = self.num_envs, self.window
    prompts = self.real_obs(self.gen, B)
    raw = self.raw_env
    dev = self.device
    wb = {
        'lcd': torch.zeros((B, W, *raw.observation_space['lcd'].shape),
                           device=dev),
        'proprio': torch.zeros((B, W, max(1, raw.pobs_size)), device=dev),
        'action': torch.zeros((B, W, raw.act_size), device=dev),
    }
    for key in self.keys:
      wb[key][:, 0] = prompts[key].float()
    if _rl(self.G, 'reset_prompt'):
      ptr = 1
    else:
      wb['action'] = uniform_actions(self.gen, wb['action'].shape, dev)
      for i in range(WARMUP):
        wb = self.model.onestep(wb, i, self.gen, _rl(self.G, 'lenv_temp'))
      wb = _slide(wb, SHIFT)
      ptr = WARMUP - SHIFT - 1
    obs = {k: wb[k][:, ptr - 1] for k in self.keys}
    if update_window_batch:
      self.window_batch = wb
      self.ptr = ptr
      self.ep_t = 0
    return obs

  def step(self, act):
    self.ep_t += 1
    wb = dict(self.window_batch)
    wb['action'] = wb['action'].clone()
    wb['action'][:, self.ptr - 1] = torch.as_tensor(
        act, dtype=torch.float32, device=self.device)
    wb = self.model.onestep(wb, self.ptr, self.gen, _rl(self.G, 'lenv_temp'))
    obs = {k: wb[k][:, self.ptr] for k in self.keys}
    self.ptr = min(1 + self.ptr, self.window - 1)
    if self.ptr == self.window - 1:
      # slide the window ring left by one (JAX: learned_env.py:96-100)
      wb = _slide(wb, 1)
      self.ptr -= 1
    self.window_batch = wb
    timeout = torch.full((self.num_envs,), self.ep_t >= self.G.ep_len,
                         device=self.device)
    rew = torch.zeros(self.num_envs, device=self.device)
    return obs, rew, timeout, {'timeout': timeout}


def load_object_localizer(env, arbiterdir):
  """The frozen ObjectLocalizer in arbiterdir (`Net.save_frozen`'s
  `ObjectLocalizer.frozen.pkl`, the port's format) as a function
  (lcd, proprio) -> (B, 2) object positions on env's device, or None
  without one (JAX: learned_env.py:108-122)."""
  path = Path(arbiterdir) / 'ObjectLocalizer.frozen.pkl'
  if not path.exists():
    return None
  from boxlcd_tpu_torch.research.nets.autoencoders import ObjectLocalizer
  with open(path, 'rb') as f:
    blob = pickle.load(f)
  model = ObjectLocalizer(env, utils.AttrDict(blob['G']))
  model.module.load_state_dict(blob['state_dict'])
  model.module.requires_grad_(False)
  print('LOADED OBJECT LOCALIZER', path)
  return torch.no_grad()(model.localize)


class RewardLenv:
  """Goals + reward on top of LearnedEnv (JAX: learned_env.py:125-245)."""

  def __init__(self, env):
    self.lenv = env
    self.G = env.G
    self.real_env = env.real_env
    self.pobs_keys = env.pobs_keys
    self.obs_keys = env.obs_keys
    dev = env.device
    idx = lambda keys, pat: torch.as_tensor(
        [keys.index(x) for x in utils.filtlist(keys, pat)], dtype=torch.long,
        device=dev)
    self._bidx = idx(self.pobs_keys, '.*(x|y):p')
    self._oidx = idx(self.obs_keys, 'object.*(x|y):p')
    self._is_cube = 'CubeGoal' in type(self.real_env).__name__
    self.obj_loc = None
    if self._is_cube and str(self.G.arbiterdir):
      self.obj_loc = load_object_localizer(env.raw_env, self.G.arbiterdir)
    B = env.num_envs
    self.goal = {
        'goal:lcd': torch.zeros(env.observation_space['lcd'].shape,
                                device=dev),
        'goal:proprio': torch.zeros(env.observation_space['proprio'].shape,
                                    device=dev),
    }
    if self._is_cube:
      self.goal['goal:object'] = torch.zeros((B, 2), device=dev)
    self.gen = torch.Generator(device=dev)
    self.gen.manual_seed(GOAL_SEED)

  @property
  def action_space(self):
    return self.lenv.action_space

  @property
  def observation_space(self):
    sp = dict(self.lenv.observation_space.spaces)
    sp['goal:lcd'] = sp['lcd']
    sp['goal:proprio'] = sp['proprio']
    if self._is_cube:
      sp['goal:object'] = spaces.Box(-1, 1, (self.lenv.num_envs, 2),
                                     np.float32)
    return spaces.Dict(sp)

  def _sample_real_goals(self):
    """Goal snapshots from real-env resets (JAX: learned_env.py:163-180)."""
    obs = self.lenv.real_obs(self.gen, self.lenv.num_envs)
    out = {'goal:lcd': obs['lcd'].float(), 'goal:proprio': obs['proprio']}
    if self._is_cube:
      out['goal:object'] = obs['full_state'][:, self._oidx]
    return out

  def _reset_goals(self, mask):
    if _rl(self.G, 'lenv_goals'):
      new = {f'goal:{k}': v for k, v in
             self.lenv.reset(update_window_batch=False).items()}
    else:
      new = self._sample_real_goals()

    def mix(n, o):
      return torch.where(mask.reshape(mask.shape + (1,) * (n.dim() - 1)),
                         n, o)
    self.goal = {k: mix(new[k], self.goal[k]) for k in self.goal}

  def reset(self, *args, **kwargs):
    self._reset_goals(torch.ones(self.lenv.num_envs, dtype=torch.bool,
                                 device=self.lenv.device))
    obs = self.lenv.reset(*args, **kwargs)
    obs.update(self.goal)
    self.last_obs = dict(obs)
    return obs

  def _delta(self, obs, goal):
    """Mean |goal - position| of obs against goal's 'goal:' keys: proprio
    positions for body goals, the localizer's object positions for cube
    goals."""
    if not self._is_cube:
      b = self._bidx
      return (goal['goal:proprio'][..., b] - obs['proprio'][..., b]
              ).abs().mean(-1)
    assert self.obj_loc is not None, 'CubeGoal lenv needs an ObjectLocalizer'
    obj = self.obj_loc(obs['lcd'], obs['proprio'])
    target = self.obj_loc(goal['goal:lcd'], goal['goal:proprio'])
    return (obj - target).abs().mean(-1)

  def comp_rew_done(self, obs):
    """(reward, goal reached, delta) per env (JAX: learned_env.py:200-226).
    diff_delt shapes the reward by the delta's decrease since the last
    observation, which body goals measure against the last observation's
    goal and cube goals against the current one, as the JAX package
    does."""
    delta = self._delta(obs, obs)
    if _rl(self.G, 'diff_delt'):
      last = self.last_obs
      rew = -0.05 + 10 * (self._delta(last, obs if self._is_cube else last)
                          - delta)
    else:
      rew = -delta
    return rew, delta < _rl(self.G, 'goal_thresh'), delta

  def step(self, act):
    obs, rew, ep_done, info = self.lenv.step(act)
    obs.update(self.goal)
    rew, goal_done, delta = self.comp_rew_done(obs)
    success = goal_done & ~ep_done
    rew = (rew + success) * self.G.rew_scale
    done = ep_done | goal_done
    info = dict(info, delta=delta, success=goal_done)
    if self.G.get('autoreset', 0):
      if bool(ep_done.all()):
        obs = self.reset()
      elif bool(goal_done.any()):
        self._reset_goals(goal_done)
    self.last_obs = dict(obs)
    return obs, rew, done, info
