"""The port's LearnedEnv / RewardLenv / PreprocVecEnv against the JAX
package's, step for step, from the same parameters (an FBT over a BVAE,
the flax init carried over by boxlcd_tpu_torch.research.nets.convert).

Both envs are wrapped in PreprocVecEnv over the same BVAE and stepped with
the same numpy actions. What JAX draws from its keys reaches the port as
values: each real reset's observations (prompts) and goal snapshots, the
uniforms of each model step (`FBT.onestep`'s u) and the warm-up's random
actions. Each step compares the observations (frames bit for bit),
rewards, dones, successes, deltas, the window pointer and the
episode clock. Two cases cover body goals (Urchin, the 10-step warm-up of
reset_prompt=0, goals from the learned env, lenv_goals=1) and cube goals
(UrchinCube, a converted ObjectLocalizer, goals from real resets), both
with diff_delt shaping, autoreset, a slide of the window ring and a full
reset on timeout, and at least one per-row goal resample.

Tolerance: 1e-5 absolute on float32 outputs; frames and bits equal.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders import ObjectLocalizer
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.convert import load_flax
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.wrappers import (
    CubeGoalEnv, LearnedEnv, PreprocVecEnv, RewardLenv, VecEnv)
from boxlcd_tpu_torch.research.wrappers import learned_env as tlearned
from research.define_config import config as jconfig
from research.nets.autoencoders.bvae import BVAE as JBVAE
from research.nets.autoencoders.object_localizer import (
    ObjectLocalizer as JObjectLocalizer)
from research.nets.video_models.fbt import FBT as JFBT
from research.wrappers import LearnedEnv as JLearnedEnv
from research.wrappers import PreprocVecEnv as JPreprocVecEnv
from research.wrappers import RewardLenv as JRewardLenv
from research.wrappers.cube_goal import CubeGoalEnv as JCubeGoalEnv
from tests.test_torch_arbiters import _close

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

NUM_ENVS = 4
WIDTHS = dict(hidden_size=32, nfilter=8, vqD=4, vqK=16, n_embed=32,
              n_head=2, n_layer=1, bs=4, lr=1e-3)
# window 10 with the warm-up: the pointer starts at 4 and the ring slides
# after 5 steps; window 6 from a prompt: it starts at 1 and slides after 4.
# goal_thresh sits inside each case's deltas, so some envs reach a goal
CASES = {
    'body': dict(env='Urchin', window=10, ep_len=8, steps=10, reset_prompt=0,
                 lenv_goals=1, goal_thresh=0.45, lenv_temp=0.8),
    'cube': dict(env='UrchinCube', window=6, ep_len=6, steps=8,
                 reset_prompt=1, lenv_goals=0, goal_thresh=0.08),
}


def _G(config, env, case, **kw):
  G = config()
  G.update(WIDTHS, wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base,
           autoreset=1, diff_delt=1, rew_scale=2.0, seed=3,
           **{k: v for k, v in case.items() if k not in ('env', 'steps')},
           **kw)
  return G


def _np(x):
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x)


def _torch(tree):
  return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


class JaxDraws:
  """Wraps a JAX LearnedEnv / RewardLenv to keep, in call order, what they
  draw from their keys: real resets' observations, goal snapshots, the
  model steps' keys and the warm-up's action keys. The port's envs take
  them from here, after the JAX call that made them."""

  def __init__(self, jl, jr, z_size, reset_prompt):
    self.prompts, self.goals, self.step_keys, self.action_keys = \
        [], [], [], []
    self.z_size = z_size
    rng_keys = []

    def keep(store, fn):
      def wrapped(*a):
        out = fn(*a)
        store.append(out)
        return out
      return wrapped

    def onestep(params, wb, i, k, temp, fn=jl._jit_onestep):
      self.step_keys.append(k)
      return fn(params, wb, i, k, temp)

    def reset(update_window_batch=True, fn=jl.reset):
      n = len(rng_keys)
      out = fn(update_window_batch)
      if not reset_prompt:   # the second key of a reset draws the actions
        self.action_keys.append(rng_keys[n + 1])
      return out

    jl._jit_prompt = keep(self.prompts, jl._jit_prompt)
    jl._jit_onestep = onestep
    jl._rng = keep(rng_keys, jl._rng)
    jl.reset = reset
    jr._sample_real_goals = keep(self.goals, jr._sample_real_goals)

  def feed(self, tl, tr, tm):
    """Route the port's draws to the queues (in place, on the instances
    and the learned-env module's uniform_actions)."""
    tl.real_obs = lambda gen, n: _torch(self.prompts.pop(0))
    tr._sample_real_goals = lambda: _torch(self.goals.pop(0))
    B = tl.num_envs

    def onestep(batch, i, gen, temp=1.0):
      u = jax.random.uniform(self.step_keys.pop(0), (B, self.z_size))
      return FBT.onestep(tm, batch, i, gen, temp,
                         u=torch.as_tensor(np.array(u)))
    tm.onestep = onestep

    def actions(gen, shape, device):
      a = jax.random.uniform(self.action_keys.pop(0), tuple(shape),
                             minval=-1, maxval=1)
      return torch.as_tensor(np.array(a))
    return actions

  def drained(self):
    return not (self.prompts or self.goals or self.step_keys
                or self.action_keys)


def jit_goals(jl, jr):
  """JAX RewardLenv._sample_real_goals (learned_env.py:164-180) with its
  vmap of reset + observe jitted: the same keys and computation through
  the JAX LearnedEnv's own jitted prompt function, which computes that
  vmap (:51-53). Op by op it takes ~5 s a call on the CPU."""
  prompt = jl._jit_prompt
  keys = [k for k in jl.obs_keys if re.match('object.*(x|y):p', k)]
  idxs = jnp.asarray([jl.obs_keys.index(k) for k in keys])

  def sample():
    jr.key, k = jax.random.split(jr.key)
    obs = prompt(jax.random.split(k, jl.num_envs))
    out = {'goal:lcd': obs['lcd'].astype(jnp.float32),
           'goal:proprio': obs['proprio']}
    if jr._is_cube:
      out['goal:object'] = obs['full_state'][:, idxs]
    return out
  return sample


def _build(name, tmp_path, mp):
  """(JAX PreprocVecEnv over RewardLenv(LearnedEnv), the port's, case,
  the draws' recorder); the port's models carry the JAX ones' params."""
  case = CASES[name]
  jenv = boxlcd_tpu.env_map[case['env']]()
  env = boxlcd_tpu_torch.env_map[case['env']](device='cpu')
  cube = name == 'cube'
  jdir, tdir = tmp_path / 'jax', tmp_path / 'port'
  jG = _G(jconfig, jenv, case, arbiterdir=jdir)
  tG = _G(tconfig, env, case, device='cpu', arbiterdir=tdir)
  # the JAX flax inits, jitted (op by op they take several times longer)
  for cls in (JBVAE, JFBT, JObjectLocalizer):
    mp.setattr(cls, 'init_params', lambda self, key, init=cls.init_params:
               jax.jit(lambda k: init(self, k))(key))
  jbvae, tbvae = JBVAE(jenv, jG), BVAE(env, tG)
  jfbt, tfbt = JFBT(jenv, jG, bvae=jbvae), FBT(env, tG, bvae=tbvae)
  host = lambda p: jax.tree_util.tree_map(np.asarray, p)
  load_flax(tbvae.module, host(jbvae.params))
  load_flax(tfbt.module, host(jfbt.params))
  jreal = treal = None
  if cube:
    jloc = JObjectLocalizer(jenv, jG)
    jloc.save_frozen(jdir)
    tloc = ObjectLocalizer(env, tG)
    load_flax(tloc.module, host(jloc.params))
    tloc.save_frozen(tdir)
    jreal, treal = JCubeGoalEnv(jenv, jG), CubeGoalEnv(env, tG)
  jl = JLearnedEnv(NUM_ENVS, jfbt, jG, real_env=jreal)
  jr = JRewardLenv(jl)
  tl = LearnedEnv(NUM_ENVS, tfbt, tG, real_env=treal)
  tr = RewardLenv(tl)
  jr._sample_real_goals = jit_goals(jl, jr)
  assert (tr._is_cube, tr.obj_loc is not None) == (jr._is_cube, cube) == (
      cube, jr.obj_loc is not None)
  draws = JaxDraws(jl, jr, tfbt.z_size, case['reset_prompt'])
  mp.setattr(tlearned, 'uniform_actions', draws.feed(tl, tr, tfbt))
  return (JPreprocVecEnv(jbvae, jr, jG), PreprocVecEnv(tbvae, tr, tG),
          case, draws)


def _compare(obs, jobs):
  assert set(obs) == set(jobs), (set(obs), set(jobs))
  for k in jobs:
    assert isinstance(obs[k], torch.Tensor), k   # the learned env's type
    # zstate is the BVAE's straight-through code, 0/1 up to a float32
    # rounding of p + (z - p), which XLA and torch round differently
    tol = 0 if k.endswith('lcd') else 1e-5
    _close(obs[k], jobs[k], tol)


@pytest.mark.parametrize('name', list(CASES))
def test_learned_env_steps_as_jax(name, tmp_path):
  with pytest.MonkeyPatch.context() as mp:
    jp, tp, case, draws = _build(name, tmp_path, mp)
    jr, tr = jp._env, tp._env
    jl, tl = jr.lenv, tr.lenv
    jobs = jp.reset()          # JAX first: the port takes its draws
    _compare(tp.reset(), jobs)
    assert draws.drained()
    assert (tl.ptr, tl.ep_t) == (jl.ptr, jl.ep_t) == (
        4 if not case['reset_prompt'] else 1, 0)
    rng = np.random.RandomState(0)
    seen = {'slide': 0, 'timeout': 0, 'goal_resample': 0}
    for t in range(case['steps']):
      act = rng.uniform(-1, 1, (NUM_ENVS, tl.raw_env.act_size)).astype(
          np.float32)
      before = jl.ptr
      jo, jrew, jdone, jinfo = jp.step(jnp.asarray(act))
      obs, rew, done, info = tp.step(torch.as_tensor(act))
      assert draws.drained()
      _compare(obs, jo)
      _close(rew, jrew)
      for k in ('success', 'timeout'):
        assert np.array_equal(_np(info[k]), np.asarray(jinfo[k])), (t, k)
      assert np.array_equal(_np(done), np.asarray(jdone)), t
      _close(info['delta'], jinfo['delta'])
      assert (tl.ptr, tl.ep_t) == (jl.ptr, jl.ep_t), t
      for k, v in jl.window_batch.items():
        _close(tl.window_batch[k], v, 0 if k == 'lcd' else 1e-5)
      timeout = bool(np.asarray(jinfo['timeout']).all())
      seen['timeout'] += timeout
      seen['slide'] += before == jl.ptr and not timeout
      seen['goal_resample'] += (not timeout) and bool(
          np.asarray(jinfo['success']).any())
    assert all(seen.values()), seen


def test_preproc_keeps_numpy_beside_the_vec_env():
  """Over the per-step VecEnv (numpy observations), zstate and
  goal:zstate are numpy arrays: the BVAE's encode of the observation."""
  env = boxlcd_tpu_torch.env_map['Urchin'](device='cpu')
  G = _G(tconfig, env, CASES['body'], device='cpu')
  bvae = BVAE(env, G)
  penv = PreprocVecEnv(bvae, VecEnv(env, NUM_ENVS, G, goal_mode='body'), G)
  obs = penv.reset()
  assert all(isinstance(v, np.ndarray) for v in obs.values())
  with torch.no_grad():
    for k in ('', 'goal:'):
      z = bvae.encode({'lcd': torch.as_tensor(obs[f'{k}lcd']).float(),
                       'proprio': torch.as_tensor(obs[f'{k}proprio'])})
      assert np.array_equal(obs[f'{k}zstate'], z.numpy())
  assert obs['zstate'].shape == (NUM_ENVS, bvae.z_size)
  assert penv.observation_space['goal:zstate'].shape == (bvae.z_size,)
