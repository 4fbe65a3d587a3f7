"""The port's RL nets and buffers (research/rl/{nets,buffers}.py) against
the JAX package's, on the CPU.

- Nets: PPOActorCritic and SACNets in all four variants (mlp, cmlp, cnn,
  bvae; with and without zdelta), built by flax's init, carried over by
  `convert.load_flax` (PPOActor's raw `log_std`, the Dense names
  `goal_preproc` and `BaseMLP_0/Dense_i`, ImgCNN's convs and their NHWC
  flatten), and applied to the same observations and normals: mu, std, v,
  actions, logp, q1 and q2 within 1e-5.
- Buffers: ReplayBuffer's store_n (with wrap-around) and sample_batch from
  one RandomState seed equal; PPOBuffer's GAE and returns within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from boxlcd_tpu_torch.research.rl import buffers as tbuf
from boxlcd_tpu_torch.research.rl import nets as tnets
from research.rl import buffers as jbuf
from research.rl import nets as jnets

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TOL = 1e-5
B, A, S, HID, NF, Z = 6, 3, 7, 32, 8, 10
LCD = (16, 24)        # ImgCNN's features: 8 x 2 x 3, flattened (h, w, c)


def _obs(seed, goal_size=S):
  rng = np.random.RandomState(seed)
  return {'proprio': rng.uniform(-1, 1, (B, S)).astype(np.float32),
          'goal:proprio': rng.uniform(-1, 1, (B, S)).astype(np.float32),
          'goal:object': rng.uniform(-1, 1, (B, 2)).astype(np.float32),
          'lcd': (rng.rand(B, *LCD) > 0.6).astype(np.float32),
          'goal:lcd': (rng.rand(B, *LCD) > 0.6).astype(np.float32),
          'zstate': (rng.rand(B, Z) > 0.5).astype(np.float32)}


def _close(ours, ref, tol=TOL):
  a = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
  err = np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64)).max()
  assert np.asarray(a).shape == np.asarray(ref).shape
  assert err <= tol, err


def _host(params):
  return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize('goal_key', ['goal:proprio', 'goal:object'])
def test_ppo_actor_critic_matches_flax(goal_key):
  obs = _obs(0)
  sub = {k: obs[k] for k in ('proprio', goal_key)}
  gsize = obs[goal_key].shape[-1]
  jac = jnets.PPOActorCritic(A, 'proprio', goal_key, S, HID)
  params = jac.init(jax.random.PRNGKey(0), sub)
  # the raw log_std moved off its init, so the test sees it carried over
  params = jax.tree_util.tree_map(lambda x: x, params)
  params['params']['pi']['log_std'] = jnp.asarray([-0.3, 0.1, -1.2])
  tac = tnets.PPOActorCritic(A, 'proprio', goal_key, S, gsize, HID)
  load_flax(tac, _host(params))
  assert set(flax_to_state_dict(_host(params))) == set(tac.state_dict())
  mu, std, v = jac.apply(params, sub)
  tmu, tstd, tv = tac({k: torch.as_tensor(x) for k, x in sub.items()})
  for ours, ref in ((tmu, mu), (tstd, std), (tv, v)):
    _close(ours, ref)
  eps = jax.random.normal(jax.random.PRNGKey(1), mu.shape)
  act = mu + std * eps
  tact = tmu + tstd * torch.as_tensor(np.array(eps))
  _close(tact, act)
  _close(tnets.gaussian_logp(tmu, tstd, tact), jnets.gaussian_logp(mu, std,
                                                                  act))


@pytest.mark.parametrize('net,zdelta', [('mlp', True), ('cmlp', True),
                                        ('cmlp', False), ('cnn', True),
                                        ('cnn', False), ('bvae', True)])
def test_sac_nets_match_flax(net, zdelta):
  obs = _obs(1)
  rng = np.random.RandomState(2)
  act = rng.uniform(-1, 1, (B, A)).astype(np.float32)
  jn = jnets.SACNets(A, 'proprio', 'goal:proprio', S, HID, net=net,
                     nfilter=NF, zdelta=zdelta)
  key = jax.random.PRNGKey(3)
  params = jn.init(jax.random.PRNGKey(4), obs, act, key)
  tn = tnets.SACNets(A, 'proprio', 'goal:proprio', S, S, HID, net=net,
                     nfilter=NF, zdelta=zdelta, lcd_shape=LCD, z_size=Z)
  load_flax(tn, _host(params))
  tobs = {k: torch.as_tensor(v) for k, v in obs.items()}
  # the actor's normals: what jax.random.normal(key, mu.shape) draws
  eps = torch.as_tensor(np.array(jax.random.normal(key, (B, A))))
  a, logp, q1, q2 = jn.apply(params, obs, act, key)
  ta, tlogp, tq1, tq2 = tn(tobs, torch.as_tensor(act), eps=eps)
  for ours, ref in ((ta, a), (tlogp, logp), (tq1, q1), (tq2, q2)):
    _close(ours, ref)
  da, dlogp = jn.apply(params, obs, None, True, method='actor')
  tda, tdlogp = tn.actor(tobs, deterministic=True)
  _close(tda, da)
  _close(tdlogp, dlogp)
  # no generator and no normals: the mean action, as JAX without a key
  _close(tn.actor(tobs)[0], da)


def test_img_cnn_flattens_as_flax():
  """ImgCNN's features in flax's (h, w, c) order: a Dense kernel carried
  over lines up with them (a (c, h, w) flatten fails this)."""
  img = (np.random.RandomState(5).rand(2, 3, *LCD) > 0.5).astype(np.float32)
  jm = jnets.ImgCNN(NF)
  params = jm.init(jax.random.PRNGKey(6), img)
  tm = tnets.ImgCNN(NF)
  load_flax(tm, _host(params))
  out = tm(torch.as_tensor(img))
  assert out.shape == (2, 3, tnets.ImgCNN.out_size(NF, LCD))
  _close(out, jm.apply(params, img))


def test_replay_buffer_matches_jax():
  shapes = {'proprio': (S,), 'lcd': LCD}
  dtypes = {'lcd': bool}
  jb = jbuf.ReplayBuffer(shapes, A, 10, obs_dtypes=dtypes)
  tb = tbuf.ReplayBuffer(shapes, A, 10, obs_dtypes=dtypes)
  rng = np.random.RandomState(7)
  for n in (4, 4, 5):           # 13 stores wrap around a buffer of 10
    o, o2 = _obs(n), _obs(n + 1)
    batch = ({k: o[k][:n] for k in shapes},
             rng.uniform(-1, 1, (n, A)).astype(np.float32),
             rng.randn(n).astype(np.float32),
             {k: o2[k][:n] for k in shapes},
             (rng.rand(n) > 0.5).astype(np.float32))
    jb.store_n(*batch)
    tb.store_n(*batch)
  assert (tb.ptr, tb.count) == (jb.ptr, jb.count) == (3, 10)
  got = tb.sample_batch(np.random.RandomState(8), 16)
  want = jb.sample_batch(np.random.RandomState(8), 16)
  for k in ('act', 'rew', 'done'):
    assert np.array_equal(got[k], want[k]), k
  for k in ('obs', 'obs2'):
    for kk in shapes:
      assert got[k][kk].dtype == np.float32
      assert np.array_equal(got[k][kk], want[k][kk]), (k, kk)


def test_ppo_buffer_matches_jax():
  T, N = 9, 3
  shapes = {'proprio': (S,)}
  jb = jbuf.PPOBuffer(shapes, A, N, T, 0.99, 0.95)
  tb = tbuf.PPOBuffer(shapes, A, N, T, 0.99, 0.95)
  rng = np.random.RandomState(9)
  for t in range(T):
    args = ({'proprio': rng.randn(N, S).astype(np.float32)},
            rng.randn(N, A).astype(np.float32),
            rng.randn(N).astype(np.float32), rng.randn(N).astype(np.float32),
            rng.randn(N).astype(np.float32))
    jb.store_n(*args)
    tb.store_n(*args)
    for i in range(N):
      if (t + i) % 4 == 3 or t == T - 1:
        last = float(rng.randn()) if i else 0.0
        jb.finish_path(i, last)
        tb.finish_path(i, last)
  got, want = tb.get(), jb.get()
  for k in ('act', 'ret', 'adv', 'logp'):
    _close(got[k], want[k], 1e-6)
  _close(got['obs']['proprio'], want['obs']['proprio'], 0)
  assert tb.ptr == 0 and not tb.path_start.any()
  _close(tbuf.discount_cumsum(np.arange(5.0), 0.9),
         jbuf.discount_cumsum(np.arange(5.0), 0.9), 1e-12)
