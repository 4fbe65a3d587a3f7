"""The port's per-step batched env (research/wrappers/vec_env.py) vs
boxlcd_tpu's, on the CPU.

- VecEnv: both loaded with the same states (JAX resets, carried over with
  load_numpy) and goals, and stepped with the same numpy actions for 3
  steps without a done: full_state and proprio within 1e-4 and rew / delta
  within 1e-4 (float noise of sums taken in another order over 3 steps),
  lcd and done equal. Body mode on Luxo here; cube mode in
  tests/test_torch_goal_env.py (the JAX side's compile of one VecEnv step
  takes 20-60 s on the CPU, so the two modes are split over two files).
- Autoreset and partial resets, as tests/test_wrappers.py checks them (no
  random streams are compared: JAX threefry and torch Philox differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.research import wrappers as twrap
from research import wrappers as jwrap
from research.define_config import config

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

N_ENVS = 4


def rl_G(**kw):
  G = config()
  G.update(goal_thresh=0.05, rew_scale=1.0, state_rew=1, diff_delt=0)
  G.update(**kw)
  return G


def _step_both(env_name, goal_mode, steps=3):
  """JAX's and the port's VecEnv loaded with the same states (JAX resets)
  and goals (the port's goal sampler), stepped with the same numpy actions;
  asserts agreement after each step."""
  G = rl_G(env=env_name)
  jenv = boxlcd_tpu.env_map[env_name](G)
  tenv = boxlcd_tpu_torch.env_map[env_name](G, device='cpu')
  jv = jwrap.VecEnv(jenv, N_ENVS, G, goal_mode=goal_mode)
  tv = twrap.VecEnv(tenv, N_ENVS, G, goal_mode=goal_mode)
  keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)
  jv.states = jax.jit(jax.vmap(lambda k: JEnv.reset(jenv, k)))(keys)
  goals = {k: v.numpy() for k, v in tv._sample_goals(tv.gen, N_ENVS).items()}
  jv.goals = {k: jnp.asarray(v) for k, v in goals.items()}
  tv.load_numpy({f: np.asarray(getattr(jv.states, f))
                 for f in physics.WorldState._fields}, goals)
  rng = np.random.default_rng(0)
  for t in range(steps):
    act = rng.uniform(-1, 1, (N_ENVS, tenv.act_size)).astype(np.float32)
    want, wrew, wdone, winfos = jv.step(act)
    got, grew, gdone, ginfos = tv.step(act)
    assert not wdone.any()
    assert np.array_equal(gdone, wdone)
    assert np.abs(grew - wrew).max() < 1e-4
    assert len(ginfos) == N_ENVS and set(ginfos[0]) == set(winfos[0])
    for gi, wi in zip(ginfos, winfos):
      assert gi['timeout'] == wi['timeout'] and gi['success'] == wi['success']
      assert abs(gi['delta'] - wi['delta']) < 1e-4
    assert set(got) == set(want), t
    for k in want:
      w, g = np.asarray(want[k]), np.asarray(got[k])
      assert g.shape == w.shape and g.dtype == w.dtype, (t, k)
      if w.dtype == bool:
        assert np.array_equal(g, w), (t, k)
      else:
        assert np.abs(g - w).max() < 1e-4, (t, k)


def test_vec_env_body_mode_matches_jax():
  _step_both('Luxo', 'body')


def test_vec_env_autoreset_and_partial_reset():
  G = rl_G(env='Dropbox')
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': 5}, device='cpu')
  venv = twrap.VecEnv(env, 2, G, goal_mode=None)
  obs = venv.reset()
  assert obs['lcd'].shape == (2, env.lcd_h, env.lcd_w)
  zero = np.zeros((2, env.act_size), np.float32)
  for t in range(5):
    obs, rew, done, infos = venv.step(zero)
    assert rew.shape == (2,) and done.shape == (2,)
    assert done.all() == (t == 4) and not (done.any() and t < 4)
  assert all(i['timeout'] for i in infos)
  # the done worlds came back as fresh episodes: their obs are the reset's
  assert (venv.states.ep_t == 0).all()
  np.testing.assert_array_equal(
      obs['full_state'],
      venv.env.observe(venv.states)['full_state'].numpy())
  obs, rew, done, infos = venv.step(zero)
  assert not done.any()

  # partial reset: only the masked worlds change, goals included
  G = rl_G(env='Luxo')
  env = boxlcd_tpu_torch.env_map['Luxo'](G, device='cpu')
  venv = twrap.VecEnv(env, N_ENVS, G, goal_mode='body')
  obs = venv.reset()
  assert obs['goal:proprio'].shape == (N_ENVS, max(1, env.pobs_size))
  obs, _, _, _ = venv.step(np.zeros((N_ENVS, env.act_size), np.float32))
  obs2 = venv.reset(idxs=[0])
  for k in ('proprio', 'goal:proprio'):
    assert not np.allclose(obs2[k][0], obs[k][0]), k
    np.testing.assert_allclose(obs2[k][1:], obs[k][1:], atol=1e-6)
  assert int(venv.states.ep_t[0]) == 0 and (venv.states.ep_t[1:] == 1).all()
