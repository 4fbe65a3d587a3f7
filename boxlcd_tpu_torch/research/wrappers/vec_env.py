"""VecEnv: the per-step batched vector env with goal conditioning, in torch.

The port of boxlcd_tpu's research/wrappers/vec_env.py (itself the batched
replacement for the reference's one-process-per-env AsyncVectorEnv): all
worlds live in one batched WorldState on the env's device, and reset / step
are batched torch calls (the physics step, then Env.observe, whose LCD frame
is the per-frame raster kernel on the card). The surface the RL and
evaluation code relies on:
  - reset(idxs) with partial resets;
  - autoreset on done;
  - goal conditioning fused in: 'body' (goal = a fresh reset's proprio
    positions) and 'cube' (goal = the object's position after a fresh reset
    and 10 zero-action settle steps), with BodyGoal/CubeGoal-style rewards;
  - numpy observations out, and one info dict per env.

Randomness comes from an explicit torch.Generator on the env's device (the
JAX version splits a PRNG key). `_core_step` and `_core_reset_some` are the
batched cores on device tensors, for callers that drive the env without the
numpy shell; `core_step_shards` is `_core_step` over a `parallel.Mesh`
(PPO's fused epoch under --mesh). `load_numpy(states, goals)` sets the
batch from numpy arrays
(boxlcd_tpu's WorldState field names), so another VecEnv's state can be
carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from boxlcd_tpu_torch import parallel, spaces, utils
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.envs.env import Env

SETTLE_STEPS = 10       # cube goals settle under zero actions
CUBE_SUCCESS = 0.05     # cube goals succeed below this mean |delta|


def _where(mask, new, old):
  """Per-world select over a leading worlds axis."""
  return torch.where(mask.view(-1, *([1] * (old.dim() - 1))), new, old)


class VecEnv:
  def __init__(self, env, num_envs, G, goal_mode=None, seed=0):
    """env: a boxlcd_tpu_torch Env (its functional core is used directly).
    goal_mode: None | 'body' | 'cube'."""
    self.env = env
    self.num_envs = num_envs
    self.G = G
    self.goal_mode = goal_mode
    self.device = env.device
    self.gen = torch.Generator(device=self.device)
    self.gen.manual_seed(seed)
    if goal_mode == 'body':
      keys = utils.filtlist(env.pobs_keys, '.*(x|y):p')
      gidx = [env.pobs_keys.index(x) for x in keys]
    elif goal_mode == 'cube':
      keys = utils.filtlist(env.obs_keys, 'object.*(x|y):p')
      gidx = [env.obs_keys.index(x) for x in keys]
    elif goal_mode is not None:
      raise ValueError(f'goal_mode must be None, body or cube: {goal_mode}')
    if goal_mode:
      self._gidx = torch.as_tensor(gidx, dtype=torch.long, device=self.device)
    self.states = None
    self.goals = None

  # -- spaces ------------------------------------------------------------------
  @property
  def action_space(self):
    return self.env.action_space

  @property
  def observation_space(self):
    sp = dict(self.env.observation_space.spaces)
    if self.goal_mode:
      sp['goal:lcd'] = sp['lcd']
      sp['goal:proprio'] = sp['proprio']
      if self.goal_mode == 'cube':
        sp['goal:object'] = spaces.Box(-1, 1, (2,), np.float32)
        sp['goal:full_state'] = sp['full_state']
    return spaces.Dict(sp)

  # -- batched cores -------------------------------------------------------------
  def _sample_goals(self, gen, n):
    """Goal snapshots of n worlds: fresh resets (+ settle steps for cube)."""
    env = self.env
    st = Env.reset(env, gen, n)
    if self.goal_mode == 'cube':
      zero = torch.zeros((n, env.act_size), device=self.device)
      for _ in range(SETTLE_STEPS):
        st = physics.step_world_batch(env.spec, st, zero)
    return Env.observe(env, st)

  def _draw_fresh(self, gen, B):
    """B fresh worlds and (with goals) their goals, drawn from gen."""
    fresh = Env.reset(self.env, gen, B)
    return fresh, self._sample_goals(gen, B) if self.goal_mode else None

  def _where_reset(self, states, goals, mask, fresh, new):
    """The fresh worlds and goals where mask (B,) bool."""
    states = physics.WorldState(*(_where(mask, f, s)
                                  for s, f in zip(states, fresh)))
    if self.goal_mode:
      goals = {k: _where(mask, new[k], goals[k]) for k in goals}
    return states, goals

  def _core_reset_some(self, states, goals, gen, mask):
    """Reset the worlds where mask (B,) bool, and resample their goals.
    Returns (states, goals, obs). Reads mask on the host: with no world to
    reset, nothing is sampled."""
    if bool(mask.any()):
      fresh, new = self._draw_fresh(gen, mask.shape[0])
      states, goals = self._where_reset(states, goals, mask, fresh, new)
    return states, goals, Env.observe(self.env, states)

  def comp_rew_done(self, obs, goals):
    """(rew, success, delta) per world: the negative mean |goal - position|
    over the goal keys, +1 on success (body: below G.goal_thresh; cube:
    below 0.05). Without goals, zeros."""
    if self.goal_mode:
      key = 'proprio' if self.goal_mode == 'body' else 'full_state'
      thresh = (self.G.goal_thresh if self.goal_mode == 'body'
                else CUBE_SUCCESS)
      gidx = self._gidx.to(obs[key].device)
      delta = (goals[key][:, gidx] - obs[key][:, gidx]).abs().mean(-1)
      success = delta < thresh
      return -delta + success, success, delta
    z = torch.zeros(obs['lcd'].shape[0], device=obs['lcd'].device)
    return z, torch.zeros_like(z, dtype=torch.bool), z

  def _step_local(self, env, states, goals, actions):
    """The draw-free part of a step, on `env`'s device: physics,
    observation, reward and done. Returns (states, obs, rew, done,
    timeout, success, delta)."""
    states, obs, _, timeout, _ = Env.step(env, states, actions)
    rew, success, delta = self.comp_rew_done(obs, goals)
    if self.goal_mode:
      done = timeout | success
      rew = rew * self.G.get('rew_scale', 1.0)
    else:
      done = timeout
    return states, obs, rew, done, timeout, success, delta

  def _core_step(self, states, goals, actions, gen):
    """One batched step with autoreset. Returns (states, goals, obs, rew,
    done, timeout, success, delta); obs of a world that was done are its
    fresh episode's first."""
    out = self.core_step_shards(parallel.Mesh([self.device]), [self.env],
                                [states], [goals], [actions], gen)
    return tuple(field[0] for field in out)

  def core_step_shards(self, mesh, envs, states, goals, actions, gen):
    """`_core_step` over a parallel.Mesh: states, goals and actions are
    lists of the devices' slices of the batch, envs the env on each device.
    Each device steps its worlds; the autoreset's fresh worlds and goals are
    drawn on the master at the whole batch's shape, as `_core_step` draws
    them, and sliced. Returns the same tuple with a list per field."""
    outs = [self._step_local(e, s, g, a)
            for e, s, g, a in zip(envs, states, goals, actions)]
    states, obs, rew, done, timeout, success, delta = map(list, zip(*outs))
    any_done = mesh.gather(done)
    if bool(any_done.any()):
      fresh, new = self._draw_fresh(gen, any_done.shape[0])
      fresh, new = mesh.shard(fresh), mesh.shard(new)
      for i, e in enumerate(envs):
        states[i], goals[i] = self._where_reset(states[i], goals[i], done[i],
                                                fresh[i], new[i])
        obs2 = Env.observe(e, states[i])
        obs[i] = {k: _where(done[i], obs2[k], o) for k, o in obs[i].items()}
    return states, goals, obs, rew, done, timeout, success, delta

  # -- numpy shell ---------------------------------------------------------------
  def _attach_goals(self, obs):
    obs = {k: v.cpu().numpy() for k, v in obs.items()}
    if self.goal_mode:
      g = {k: v.cpu().numpy() for k, v in self.goals.items()}
      obs['goal:lcd'] = g['lcd']
      obs['goal:proprio'] = g['proprio']
      if self.goal_mode == 'cube':
        obs['goal:full_state'] = g['full_state']
        obs['goal:object'] = g['full_state'][:, self._gidx.cpu().numpy()]
    return obs

  def load_numpy(self, states, goals=None):
    """Set the batch from numpy arrays: `states` a dict (or WorldState-like)
    with boxlcd_tpu's WorldState field names, `goals` a dict of goal
    observations ('lcd', 'proprio', 'full_state'), as another VecEnv holds
    them. Returns the observations, as reset does."""
    self.states = physics.state_from_numpy(states, self.device)
    if self.goal_mode:
      self.goals = {k: torch.as_tensor(np.asarray(goals[k]),
                                       device=self.device)
                    for k in ('lcd', 'proprio', 'full_state')}
    return self._attach_goals(Env.observe(self.env, self.states))

  def reset(self, idxs=None):
    B = self.num_envs
    if self.states is None:
      self.states = Env.reset(self.env, self.gen, B)
      if self.goal_mode:
        self.goals = self._sample_goals(self.gen, B)
      return self._attach_goals(Env.observe(self.env, self.states))
    mask = torch.zeros(B, dtype=torch.bool, device=self.device)
    if idxs is None:
      mask[:] = True
    else:
      mask[torch.as_tensor(np.atleast_1d(idxs), device=self.device)] = True
    self.states, self.goals, obs = self._core_reset_some(
        self.states, self.goals, self.gen, mask)
    return self._attach_goals(obs)

  def step(self, actions):
    actions = torch.as_tensor(np.asarray(actions, np.float32),
                              device=self.device)
    (self.states, self.goals, obs, rew, done, timeout, success,
     delta) = self._core_step(self.states, self.goals, actions, self.gen)
    obs = self._attach_goals(obs)
    infos = [{'timeout': bool(t), 'success': bool(s), 'delta': float(d)}
             for t, s, d in zip(timeout.cpu().numpy(), success.cpu().numpy(),
                                delta.cpu().numpy())]
    return obs, rew.cpu().numpy(), done.cpu().numpy(), infos
