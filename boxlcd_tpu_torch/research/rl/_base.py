"""RL base: env construction (real batched or learned) + test harness (the
port of research/rl/_base.py). The real vector env is the batched VecEnv
(one lcd raster launch a step on the card); the learned env is
RewardLenv(LearnedEnv(model)): RL inside the world model. `G.preproc`
stacks PreprocVecEnv over both. Everything runs on `G.device` (the card
unless --device=cpu)."""
from __future__ import annotations

import numpy as np
import torch

from boxlcd_tpu_torch.research import utils
from boxlcd_tpu_torch.research.define_config import env_fn
from boxlcd_tpu_torch.research.wrappers import (
    LearnedEnv, PreprocVecEnv, RewardLenv, VecEnv)

TN = 8  # test-env batch (reference: rl/_base.py:15)


def goal_mode_for(G):
  if not G.goals:
    return None
  return 'cube' if 'Cube' in G.env else 'body'


def to_numpy(x):
  """A tensor (on any device) or an array as a numpy array."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def _load_model(name, weightdir, env):
  """net_map[name] over `env`, from the checkpoint in weightdir (its G,
  its weights)."""
  from boxlcd_tpu_torch.research.nets import net_map
  from boxlcd_tpu_torch.research.nets._base import Net
  model = net_map[name](env, Net.load_config(weightdir, name))
  model.load(weightdir, resume=False)
  return model


class RLAlgo:
  def __init__(self, G):
    self.G = G
    self.logger = utils.AutoLogger()
    self.writer = utils.make_writer(G.logdir)
    self.tenv = env_fn(G, G.seed)()  # goal-wrapped single test env
    self.obs_space = self.tenv.observation_space
    self.act_space = self.tenv.action_space
    raw = self.tenv._env if hasattr(self.tenv, '_env') else self.tenv
    self.device = raw.device
    gm = goal_mode_for(G)
    self.real_tvenv = VecEnv(raw, TN, G, goal_mode=gm, seed=G.seed + 1)
    if G.lenv:
      model = _load_model(G.model, G.weightdir, raw)
      self.env = RewardLenv(LearnedEnv(G.num_envs, model, G,
                                       real_env=self.tenv))
      self.tvenv = self.learned_tvenv = RewardLenv(
          LearnedEnv(TN, model, G, real_env=self.tenv))
      self.obs_space = self.env.observation_space
    else:
      self.env = VecEnv(raw, G.num_envs, G, goal_mode=gm, seed=G.seed + 2)
      self.tvenv = self.real_tvenv
    if G.get('preproc'):
      # frozen-AE observation preprocessing: obs gain zstate / goal:zstate
      # (reference: rl/_base.py Preproc stacking + preproc_vec_env.py)
      pname = str(G.get('preproc_net', 'BVAE'))
      preproc = _load_model(pname, G.preproc, raw)
      self.env = PreprocVecEnv(preproc, self.env, G)
      self.real_tvenv = PreprocVecEnv(preproc, self.real_tvenv, G)
      if G.lenv:
        self.learned_tvenv = PreprocVecEnv(preproc, self.learned_tvenv, G)
      self.tvenv = self.real_tvenv if not G.lenv else self.learned_tvenv
      self.obs_space = self.env.observation_space
    self.goal_key = ('goal:object'
                     if type(self.tenv).__name__ == 'CubeGoalEnv'
                     else 'goal:proprio')

  def env_action(self, a):
    """An action batch as the training env takes it: a tensor on the device
    for the learned env, a numpy array for the real one."""
    return a if self.G.lenv else to_numpy(a)

  def get_a(self, o, deterministic=False):
    raise NotImplementedError

  def test_agent(self, itr, use_lenv=False):
    """Run the policy in the (real or learned) env; log EpRet/EpLen/success
    (reference: rl/_base.py:83-175)."""
    _env = self.learned_tvenv if use_lenv else self.real_tvenv
    prefix = 'lenv_' if use_lenv else ''
    o = _env.reset()
    ep_ret = np.zeros(TN)
    ep_len = np.zeros(TN)
    succeeded = np.zeros(TN, bool)
    ep_done = np.zeros(TN, bool)
    for t in range(self.G.ep_len):
      # the reference samples stochastic actions at test time despite its
      # "deterministic" comment (pponets.py:102-113 — act() -> pi.sample());
      # match that protocol (the G flag opts into the mean-action variant)
      a = self.get_a(o, deterministic=bool(self.G.get('test_deterministic',
                                                      0)))
      o, rew, done, info = _env.step(a if use_lenv else to_numpy(a))
      rew = to_numpy(rew)
      done = to_numpy(done)
      ep_ret += rew * ~ep_done
      ep_len += ~ep_done
      if isinstance(info, list):
        succ = np.array([i.get('success', False) for i in info])
      else:
        succ = to_numpy(info.get('success', np.zeros(TN, bool)))
      succeeded |= (succ & ~ep_done)
      ep_done |= done
      if ep_done.all():
        break
    self.logger[f'{prefix}test/EpRet'] = ep_ret.mean()
    self.logger[f'{prefix}test/EpLen'] = ep_len.mean()
    self.logger[f'{prefix}test/success_rate'] = succeeded.mean()
    return succeeded.mean()
