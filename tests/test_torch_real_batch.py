"""The probes' real batch (fit_diag.rollout_batch, which model_probe and
fit_diag roll) on the CPU against the JAX scripts' scan of Env.step: the
observation after each step, from JAX's resets and numpy actions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.research.scripts import fit_diag
from tests.test_torch_physics import BOUNDS

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

G_ENV = {'vel_iters': 8, 'pos_iters': 4}


def _np(x):
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x)


def test_real_batch_plain_matches_jax_scan():
  """From JAX's resets and numpy actions: poses within
  tests/test_torch_physics.py's Urchin bounds per world, the first step's
  within 1e-4, proprio likewise, frames bit for bit."""
  B, T = 8, 5
  jenv = boxlcd_tpu.env_map['Urchin'](G_ENV)
  env = boxlcd_tpu_torch.env_map['Urchin'](G_ENV, device='cpu')
  states = jax.jit(jax.vmap(lambda k: JEnv.reset(jenv, k)))(
      jax.random.split(jax.random.PRNGKey(3), B))
  acts = np.random.default_rng(0).uniform(
      -1, 1, (B, T, env.act_size)).astype(np.float32)

  def body(st, a):
    nst, obs, *_ = JEnv.step(jenv, st, a)
    return nst, (obs['lcd'].astype(jnp.float32), obs['proprio'], nst.c,
                 nst.a)
  _, (lcd, pro, c, a) = jax.jit(jax.vmap(
      lambda s, a: jax.lax.scan(body, s, a)))(states, acts)
  ref = {'lcd': lcd, 'proprio': pro, 'c': c, 'a': a}
  got = fit_diag.rollout_batch(env, physics.state_from_numpy(states, 'cpu'),
                               torch.as_tensor(acts))
  assert got['lcd'].shape == (B, T, env.lcd_h, env.lcd_w)
  med_b, tail_at, tail_frac = BOUNDS['Urchin']
  for k in ('c', 'a', 'proprio'):
    err = np.abs(_np(got[k]) - np.asarray(ref[k]))
    assert err[:, 0].max() < 1e-4, f'{k} after the first step'
    per_world = err.reshape(B, -1).max(1)
    assert np.median(per_world) < med_b, k
    assert (per_world > tail_at).mean() < tail_frac, k
  assert np.array_equal(_np(got['lcd']), np.asarray(ref['lcd']))
  assert np.array_equal(_np(got['action']), acts)
