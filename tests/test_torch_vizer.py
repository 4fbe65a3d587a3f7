"""The port's Vizer, AutoEnv and InteractiveVizer against the JAX
package's (research/runners/vizer.py), from the same parameters (the flax
inits of FIT, FBT and its BVAE, carried over by
boxlcd_tpu_torch.research.nets.convert).

What JAX draws from its keys reaches the port as values: the reset state,
the actions, each sample's uniforms (`sample(..., u=)`) and `onestep`'s.
- `optimize_actions` for FIT and FBT: losses and planned actions within
  1e-4 of JAX's, prompt actions unchanged, |a| <= 1, no gradient on any
  parameter; and the port counterparts of tests/test_round2.py:122,142
  from the port's own init.
- `Vizer.run`: the truth frames equal to JAX's bit for bit (decoded from
  JAX's gifs), the prompted samples' frames too.
- `AutoEnv`: the counterpart of tests/test_round3.py (priming, lockstep,
  sliding), and one model step fed JAX's window and uniforms equal to
  JAX's prediction; the headless `InteractiveVizer` falls back to `run`.
"""
import jax
import numpy as np
import pytest
import torch
from PIL import Image

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.research.define_config import config as tconfig
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.convert import load_flax
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.nets.video_models.fit import FIT
from boxlcd_tpu_torch.research.runners import vizer as tvizer
from research.define_config import config as jconfig
from research.nets.autoencoders.bvae import BVAE as JBVAE
from research.nets.video_models.fbt import FBT as JFBT
from research.nets.video_models.fit import FIT as JFIT
from research.runners import vizer as jvizer
from tests.test_torch_bvae import _close, fake_batch, tiny_G

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TOL = 1e-4
PN = 2          # prompt_n


def host(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def models():
  """{'FIT' | 'FBT': (JAX model, port model with its parameters)} on
  Dropbox, window 6, prompt_n 2; the envs and the two G."""
  jenv = boxlcd_tpu.env_map['Dropbox']()
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  jG = tiny_G(jconfig, jenv, prompt_n=PN, seed=3)
  tG = tiny_G(tconfig, env, prompt_n=PN, seed=3, device='cpu')
  with pytest.MonkeyPatch.context() as mp:
    # the flax inits jitted: op by op they take several times longer here
    for cls in (JBVAE, JFBT, JFIT):
      mp.setattr(cls, 'init_params', lambda self, key, init=cls.init_params:
                 jax.jit(lambda k: init(self, k))(key))
    jfbt = JFBT(jenv, jG, bvae=JBVAE(jenv, jG))
    jfit = JFIT(jenv, jG)
  tfbt = FBT(env, tG, bvae=BVAE(env, tG))
  load_flax(tfbt.bvae.module, host(jfbt.bvae.params))
  load_flax(tfbt.module, host(jfbt.params))
  tfit = FIT(env, tG)
  load_flax(tfit.module, host(jfit.params))
  return {'FIT': (jfit, tfit), 'FBT': (jfbt, tfbt)}, (jenv, env), (jG, tG)


def sample_u(key, tm, n=1):
  """The uniforms JAX's `sample(key, ...)` draws (FIT and FBT alike):
  position i's from split(split(key)[1], T)[i]; (T, n, token size)."""
  size = tm.z_size if tm.name == 'FBT' else tm.imsize
  keys = jax.random.split(jax.random.split(key)[1], tm.block_size)
  return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, (n, size)))
                                   for k in keys]))


def opt_u(key, tm, iters):
  """The uniforms of JAX's `optimize_actions(key, ...)`: one sample an
  iteration, on key, k = split(key)."""
  us = []
  for _ in range(iters):
    key, k = jax.random.split(key)
    us.append(sample_u(k, tm))
  return us


@pytest.mark.parametrize('name', ['FIT', 'FBT'])
def test_optimize_actions_matches_jax(models, name):
  (jm, tm), (jenv, env), (jG, tG) = models[0][name], *models[1:]
  batch = fake_batch(env, B=1, T=6, seed=1)
  goal = batch['lcd'][0, -1]
  key = jax.random.PRNGKey(5)
  iters = 3 if name == 'FIT' else 2      # tests/test_round2.py's
  ja, jl0, jl1 = jvizer.Vizer(jm, jenv, jG).optimize_actions(
      key, batch['action'], {k: batch[k] for k in ('lcd', 'proprio')}, goal,
      iters=iters, lr=0.5)
  tm.module.zero_grad(set_to_none=True)
  prompts = {k: torch.as_tensor(batch[k]) for k in ('lcd', 'proprio')}
  ta, tl0, tl1 = tvizer.Vizer(tm, env, tG).optimize_actions(
      None, batch['action'], prompts, goal, iters=iters, lr=0.5,
      u=opt_u(key, tm, iters))
  assert abs(tl0 - jl0) <= TOL and abs(tl1 - jl1) <= TOL, (tl0, jl0, tl1, jl1)
  _close(ta, ja, TOL)
  assert torch.equal(ta[:, :PN], torch.as_tensor(batch['action'][:, :PN]))
  assert not np.allclose(ta[:, PN:].numpy(), batch['action'][:, PN:])
  assert float(ta.abs().max()) <= 1.0
  # only the actions took a gradient
  modules = [tm.module] + ([tm.bvae.module] if name == 'FBT' else [])
  assert all(p.grad is None for m in modules for p in m.parameters())


@pytest.mark.parametrize('name', ['FIT', 'FBT'])
def test_optimize_actions_own_init(name):
  """tests/test_round2.py:122 (FIT) and :142 (FBT) for the port: the plan
  runs from the port's own init and its own draws, keeps the prompt
  actions, moves the others and respects the bounds."""
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  G = tiny_G(tconfig, env, prompt_n=PN, device='cpu')
  model = FIT(env, G) if name == 'FIT' else FBT(env, G, bvae=BVAE(env, G))
  batch = {k: torch.as_tensor(v) for k, v in
           fake_batch(env, B=1, T=6).items()}
  prompts = {k: batch[k] for k in ('lcd', 'proprio')}
  a1, l0, l1 = tvizer.Vizer(model, env, G).optimize_actions(
      torch.Generator().manual_seed(0), batch['action'], prompts,
      batch['lcd'][0, -1].numpy(), iters=3, lr=0.5)
  assert np.isfinite(l0) and np.isfinite(l1)
  assert torch.equal(a1[:, :PN], batch['action'][:, :PN])
  if name == 'FIT':
    assert not torch.allclose(a1[:, PN:], batch['action'][:, PN:])
  assert float(a1.abs().max()) <= 1.0


def _gif_frames(path):
  with Image.open(path) as im:
    frames = []
    for i in range(im.n_frames):
      im.seek(i)
      frames.append(np.asarray(im.convert('L')))
  return np.stack(frames)


def vizer_draws(key, tm, raw_jenv, T):
  """What JAX's Vizer.run draws for one rollout: the reset state (batched
  for the port), the actions and the sample's uniforms."""
  key, k_env, k_act, k_samp = jax.random.split(key, 4)
  js = JEnv.reset(raw_jenv, k_env)
  state = physics.state_from_numpy(
      {f: np.asarray(getattr(js, f))[None] for f in physics.WorldState._fields},
      'cpu')
  actions = np.array(jax.random.uniform(
      k_act, (T, raw_jenv.act_size), minval=-1, maxval=1))
  return {'state': state, 'actions': actions, 'u': sample_u(k_samp, tm)}


def test_run_truth_and_samples_match_jax(models, tmp_path):
  """Two rollouts of JAX's Vizer.run and the port's fed its draws: every
  frame of the truth-over-sample gifs equal, bit for bit (the planning
  half of `run` is held to JAX above)."""
  (jm, tm), (jenv, env), (jG, tG) = models[0]['FBT'], *models[1:]
  jG = type(jG)(jG, logdir=str(tmp_path / 'jax'))
  tG = type(tG)(tG, logdir=str(tmp_path / 'port'))
  jvizer.Vizer(jm, jenv, jG).run(n_rollouts=2)
  key, draws = jax.random.PRNGKey(jG.seed), []
  for _ in range(2):
    draws.append(vizer_draws(key, tm, jenv, tm.block_size))
    key = jax.random.split(key, 4)[0]
  recs = tvizer.Vizer(tm, env, tG).run(n_rollouts=2, draws=draws)
  H = env.lcd_h
  for r, rec in enumerate(recs):
    want = _gif_frames(tmp_path / 'jax' / f'viz_rollout_{r}.gif')
    got = _gif_frames(rec['gif'])
    assert want.shape == got.shape == (tm.block_size, 2 * H, env.lcd_w)
    assert np.array_equal(got, want), r
    # the truth half is the frames the env rendered, not a gif's rounding
    assert np.array_equal(rec['truth'] * 255, want[:, :H])


@pytest.fixture
def autoenv_pair(models):
  (jm, tm), (jenv, env), (jG, tG) = models[0]['FBT'], *models[1:]
  return jm, tm, jenv, env, jG, tG


def test_autoenv_live_stepper(autoenv_pair):
  """tests/test_round3.py's AutoEnv test for the port."""
  _, tm, _, env, _, G = autoenv_pair
  env.seed(0)
  ae = tvizer.AutoEnv(tm, env, G)
  truth, pred, goal = ae.reset()
  assert truth.shape == (env.lcd_h * 8, env.lcd_w * 8, 3)
  assert goal is None  # plain env: no goal pane
  assert ae.window_batch['lcd'].shape[1] == G.window
  count0 = ae.count
  for _ in range(3):
    truth, pred, rew, lrew, goal = ae.step(env.action_space.sample())
  assert truth.shape == pred.shape == (env.lcd_h * 8, env.lcd_w * 8, 3)
  assert ae.tot_count == 3
  assert ae.count == min(count0 + 3, G.window - 2)
  assert np.isfinite(ae.window_batch['lcd']).all()


def test_autoenv_model_step_matches_jax(autoenv_pair):
  """JAX's AutoEnv and the port's, each over a port env seeded alike (the
  truth is held to JAX by the run test; this holds the model half), primed
  from one action stream to the pointer window - 2, then one lockstep with
  the same action and JAX's onestep uniforms: the same predicted frame bit
  for bit, the same window (1e-5) after the slide, the same pointer."""
  jm, tm, _, _, jG, tG = autoenv_pair
  aes = []
  for cls, model, G in ((jvizer.AutoEnv, jm, jG), (tvizer.AutoEnv, tm, tG)):
    env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
    env.seed(0)
    np.random.seed(0)          # the priming actions
    aes.append(cls(model, env, G))
    aes[-1].reset()
  jae, tae = aes
  assert jae.count == tae.count == jG.window - 2
  for name in jae.window_batch:
    assert np.array_equal(tae.window_batch[name], jae.window_batch[name])
  k = jax.random.PRNGKey(9)
  act = np.random.RandomState(0).uniform(-1, 1, tm.act_n).astype(np.float32)
  u = torch.as_tensor(np.array(jax.random.uniform(k, (1, tm.z_size))))
  jt, jp, *_ = jae.step(act, k)
  tt, tp, *_ = tae.step(act, u=u)
  assert np.array_equal(tt, jt) and np.array_equal(tp, jp)
  assert tae.count == jae.count
  for name in jae.window_batch:
    _close(tae.window_batch[name], jae.window_batch[name])


def test_interactive_vizer_headless_fallback(autoenv_pair, tmp_path):
  """tests/test_round3.py: without pyglet or a display, InteractiveVizer
  constructs and runs the headless replay."""
  _, tm, _, env, _, G = autoenv_pair
  G = type(G)(G, logdir=str(tmp_path), optimize_actions=0)
  viz = tvizer.InteractiveVizer(tm, env, G)
  assert not viz.have_window
  (rec,) = viz.run(n_rollouts=1)
  assert (tmp_path / 'viz_rollout_0.gif').exists()
  assert rec['truth'].shape == (tm.block_size, env.lcd_h, env.lcd_w)
