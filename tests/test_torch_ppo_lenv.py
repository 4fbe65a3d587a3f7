"""The port's fused learned-env PPO epoch (research/rl/ppo.py
`lenv_rollout`) against the JAX package's `_lenv_rollout`, on the CPU.

Both run over a tiny FBT over a BVAE (test_torch_learned_env.py's widths,
the flax inits carried over by `convert.load_flax`) at 4 envs, over steps
that cross a window slide, the lockstep timeout and per-row goal
resamples. JAX's draws reach the port as values: the prompt and goal
pools (its vmapped real resets), the action normals, the onestep uniforms
and the pool indices, each from the key JAX splits. The trajectory (obs,
a, rew, v, logp, done, success) within 1e-5, frames and the final window
batch's lcd equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.convert import load_flax
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.rl.ppo import pool_size
from boxlcd_tpu_torch.research.wrappers import LearnedEnv, RewardLenv
from research.nets.autoencoders.bvae import BVAE as JBVAE
from research.nets.video_models.fbt import FBT as JFBT
from research.wrappers import LearnedEnv as JLearnedEnv
from research.wrappers import RewardLenv as JRewardLenv
from tests.test_torch_ppo import (  # noqa: F401 (the writers' stub)
    NUM_ENVS, _close, _host, _pair, no_tensorboard)

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

# test_torch_learned_env.py's widths; window 6 from a prompt: the pointer
# starts at 1 and the ring slides at step 4; ep_len 6: the lockstep
# timeout at step 6; goal_thresh inside the deltas, so some rows reach
# their goal
WIDTHS = dict(nfilter=8, vqD=4, vqK=16, n_embed=32, n_head=2, n_layer=1,
              bs=4, lr=1e-3)
LENV = ['--window=6', '--ep_len=6', '--goal_thresh=0.45', '--rew_scale=2.0',
        '--lenv_temp=0.8']
LENV_STEPS = 8


@pytest.fixture
def lenv_pair(tmp_path, monkeypatch):
  """(JAX PPO, port PPO) whose envs are RewardLenv(LearnedEnv) over one
  tiny FBT over a BVAE; JAX's fused rollout built."""
  jppo, tppo = _pair(tmp_path, *LENV)
  jG, tG = jppo.G, tppo.G
  jG.update(WIDTHS)
  tG.update(WIDTHS)
  for cls in (JBVAE, JFBT):     # the flax inits, jitted
    monkeypatch.setattr(cls, 'init_params', lambda self, key,
                        init=cls.init_params:
                        jax.jit(lambda k: init(self, k))(key))
  jraw, traw = jppo.tenv._env, tppo.tenv._env
  jbvae, tbvae = JBVAE(jraw, jG), BVAE(traw, tG)
  jfbt, tfbt = JFBT(jraw, jG, bvae=jbvae), FBT(traw, tG, bvae=tbvae)
  load_flax(tbvae.module, _host(jbvae.params))
  load_flax(tfbt.module, _host(jfbt.params))
  jppo.env = JRewardLenv(JLearnedEnv(NUM_ENVS, jfbt, jG,
                                     real_env=jppo.tenv))
  tppo.env = RewardLenv(LearnedEnv(NUM_ENVS, tfbt, tG, real_env=tppo.tenv))
  jppo._build_fused_lenv()
  return jppo, tppo


def _jax_draws(jppo, key, steps, z_size):
  """What JAX's rollout draws from `key` (ppo.py:256-295), as torch
  values: the pools from its vmapped real resets, and per step the action
  normals, the onestep uniforms and the pool indices."""
  lenv = jppo.env.lenv
  raw, B = lenv.raw_env, lenv.num_envs
  A = raw.act_size
  POOL = max(4 * B, 256)
  kp1, kp2, key = jax.random.split(key, 3)
  observe = jax.jit(jax.vmap(lambda k: JEnv.observe(raw, JEnv.reset(raw, k))))

  def pool(k):
    o = observe(jax.random.split(k, POOL))
    return {'lcd': o['lcd'].astype(jnp.float32), 'proprio': o['proprio']}
  draws = {'prompt_pool': pool(kp1), 'goal_pool': pool(kp2),
           'eps': [], 'u': [], 'pidx': [], 'gidx': []}
  for k in jax.random.split(key, steps):
    k1, k2, k3, k4 = jax.random.split(k, 4)
    draws['eps'].append(jax.random.normal(k1, (B, A)))
    draws['u'].append(jax.random.uniform(k2, (B, z_size)))
    draws['pidx'].append(jax.random.randint(k3, (B,), 0, POOL))
    draws['gidx'].append(jax.random.randint(k4, (B,), 0, POOL))
  t = lambda x: torch.as_tensor(np.array(x))
  return {k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else t(np.stack(v))) for k, v in draws.items()}


def test_fused_lenv_epoch_matches_jax_rollout(lenv_pair):
  jppo, tppo = lenv_pair
  jr, tr = jppo.env, tppo.env
  key = jax.random.PRNGKey(11)
  draws = _jax_draws(jppo, key, LENV_STEPS, tr.lenv.model.z_size)
  assert draws['prompt_pool']['lcd'].shape[0] == pool_size(NUM_ENVS) == 256
  # the start: the pools' first rows as prompts and goals, pointer 1
  B, W = NUM_ENVS, tr.lenv.window
  prompts = {k: v[:B] for k, v in draws['prompt_pool'].items()}
  wb = tppo._fresh_wb(prompts)
  goals = {f'goal:{k}': v[B:2 * B] for k, v in draws['goal_pool'].items()}
  jwb = {k: jnp.asarray(v.numpy()) for k, v in wb.items()}
  jgoals = {k: jnp.asarray(v.numpy()) for k, v in goals.items()}
  jwb, jptr, jep, jgoals, jtraj, jlast = jppo._lenv_rollout(
      jppo.params, jr.lenv.model.params, jwb, jnp.int32(1), jnp.int32(0),
      jgoals, key, LENV_STEPS)
  wb, ptr, ep_t, goals, traj, last_v = tppo.lenv_rollout(
      wb, 1, 0, goals, LENV_STEPS, draws=draws)
  (jo, ja, jrew, jv, jlogp, jdone, jsucc) = _host(jtraj)
  (o, a, rew, v, logp, done, succ) = traj
  for k in jo:
    _close(o[k], jo[k], 1e-5)
  for ours, ref in ((a, ja), (rew, jrew), (v, jv), (logp, jlogp),
                    (last_v, jlast)):
    _close(ours, ref, 1e-5)
  assert np.array_equal(done, jdone) and np.array_equal(succ, jsucc)
  assert (ptr, ep_t) == (int(jptr), int(jep))
  for k in jwb:
    _close(wb[k], jwb[k], 0 if k == 'lcd' else 1e-5)
  _close(goals['goal:lcd'], jgoals['goal:lcd'], 0)
  _close(goals['goal:proprio'], jgoals['goal:proprio'], 0)
  # the steps crossed a slide (step 4), the lockstep timeout (step 6) and
  # goal resamples of some rows only
  assert done[5].all() and not done[6:].all()
  goal_rows = done[:5] & ~done[:5].all(1, keepdims=True)
  assert goal_rows.any() and succ.any()
