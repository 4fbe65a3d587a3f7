"""The port's PPO (research/rl/ppo.py) against the JAX package's, on the
CPU, from the same parameters (the flax init carried over by
`convert.load_flax`).

- Updates: two `_pi_update` then two `_v_update` steps from the same
  parameters and minibatch: parameters within 1e-5 of optax's after each
  (torch Adam over each loss's own parameters against optax Adam over the
  whole tree, whose other half's gradients are zero); loss, kl and entropy
  within 1e-6 relative.
- `_store_traj`: one (T, B) trajectory made from a seed, with successes,
  timeouts and an epoch cut, fed to both: the GAE buffer's obs, act, ret,
  adv and logp within 1e-6, the episode counters and logs equal.
- The fused real-env epoch (`rollout`) against the port's own step loop
  (`get_av` + `VecEnv.step`) with the same normals and the same VecEnv
  generator state, through autoresets: equal (the VecEnv itself is held
  to JAX by tests/test_torch_vec_env.py).
The fused learned-env epoch is held to JAX's in tests/test_torch_ppo_lenv.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from boxlcd_tpu_torch.research.rl import main as tmain
from boxlcd_tpu_torch.research.rl.ppo import PPO
from research import utils as jutils
from research.rl import main as jmain
from research.rl.ppo import PPO as JPPO

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

NUM_ENVS = 4
ARGS = ['--env=Urchin', f'--num_envs={NUM_ENVS}', '--hidden_size=32',
        '--vel_iters=2', '--pos_iters=1', '--log_n=100000']


class NullWriter:
  def add_scalar(self, *a, **k):
    pass

  def flush(self):
    pass


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
  """Both packages' writers stubbed (a TensorBoard writer imports
  TensorFlow, ~10 s here)."""
  for mod in (tutils, jutils):
    monkeypatch.setattr(mod, 'make_writer', lambda logdir: NullWriter())


def _host(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _close(ours, ref, tol):
  a = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
  a, b = np.asarray(a, np.float64), np.asarray(ref, np.float64)
  assert a.shape == b.shape, (a.shape, b.shape)
  err = np.abs(a - b).max() if a.size else 0.0
  assert err <= tol, err


def _rel(ours, ref, rtol=1e-6):
  a, b = float(ours), float(ref)
  assert abs(a - b) <= rtol * abs(b), (a, b)


def _pair(tmp_path, *extra):
  """JAX's PPO and the port's from one argv (real env), the port's
  actor-critic carrying JAX's initial parameters."""
  argv = [*ARGS, f'--logdir={tmp_path}', *extra, 'ppo']
  jppo = JPPO(jmain.parse(argv))
  tppo = PPO(tmain.parse(['--device=cpu', *argv]))
  load_flax(tppo.ac, _host(jppo.params))
  return jppo, tppo


def _params_close(jparams, tmodule, tol=1e-5):
  want = flax_to_state_dict(_host(jparams))
  got = tmodule.state_dict()
  assert set(want) == set(got)
  for k in want:
    _close(got[k], want[k], tol)


def test_pi_and_v_updates_match_optax(tmp_path):
  jppo, tppo = _pair(tmp_path)
  rng = np.random.RandomState(0)
  n, S = 64, tppo.obs_space['proprio'].shape[-1]
  obs = {'proprio': rng.uniform(-1, 1, (n, S)).astype(np.float32),
         'goal:proprio': rng.uniform(-1, 1, (n, S)).astype(np.float32)}
  mu, std = tppo.ac.policy({k: torch.as_tensor(v) for k, v in obs.items()})
  act = (mu + std * torch.randn(mu.shape, generator=torch.Generator()
                                .manual_seed(1))).detach().numpy()
  lp = rng.normal(-2.5, 0.5, n).astype(np.float32)   # old logp: kl != 0
  batch = {'obs': obs, 'act': act, 'logp': lp,
           'adv': rng.randn(n).astype(np.float32),
           'ret': rng.randn(n).astype(np.float32)}
  jb = jax.tree_util.tree_map(jnp.asarray, batch)
  tb = jax.tree_util.tree_map(torch.as_tensor, batch)
  params = jppo.params
  for _ in range(2):
    params, jppo.pi_state, *jout = jppo._pi_update(params, jppo.pi_state, jb)
    tout = tppo._pi_update(tb)
    _params_close(params, tppo.ac)
    for ours, ref in zip(tout, jout):     # loss, kl, entropy
      _rel(ours, ref)
  for _ in range(2):
    params, jppo.v_state, jloss = jppo._v_update(params, jppo.v_state, jb)
    _rel(tppo._v_update(tb), jloss)
    _params_close(params, tppo.ac)


def _trajectory(T, B, S, A, ep_len, seed):
  """A (T, B) trajectory as the fused epochs give it, made from a seed:
  each row done on success (at random) or on its timeout (ep_len steps
  since its episode began, counting the episode lengths it starts with)."""
  rng = np.random.RandomState(seed)
  ep = rng.randint(0, ep_len, B)
  start = ep.copy()
  done = np.zeros((T, B), bool)
  succ = np.zeros((T, B), bool)
  for t in range(T):
    ep += 1
    succ[t] = rng.rand(B) < 0.15
    done[t] = succ[t] | (ep >= ep_len)
    succ[t] &= ep < ep_len
    ep[done[t]] = 0
  o = {'proprio': rng.randn(T, B, S).astype(np.float32),
       'goal:proprio': rng.randn(T, B, S).astype(np.float32)}
  return (o, rng.randn(T, B, A).astype(np.float32),
          rng.randn(T, B).astype(np.float32),
          rng.randn(T, B).astype(np.float32),
          rng.randn(T, B).astype(np.float32), done, succ), \
      rng.randn(B).astype(np.float32), start


def test_store_traj_matches_jax(tmp_path):
  ep_len, T = 5, 12
  jppo, tppo = _pair(tmp_path, f'--ep_len={ep_len}',
                     f'--steps_per_epoch={T * NUM_ENVS}')
  S, A = tppo.obs_space['proprio'].shape[-1], tppo.act_space.shape[-1]
  traj, last_v, start = _trajectory(T, NUM_ENVS, S, A, ep_len, seed=2)
  done = traj[5]
  assert done[-1].sum() < NUM_ENVS      # an epoch cut: open paths at T
  assert (traj[6] & done).any() and (done & ~traj[6]).any()
  out = {}
  for name, algo in (('jax', jppo), ('port', tppo)):
    ep_ret, ep_len_acc = np.zeros(NUM_ENVS), start.astype(np.float64)
    ep_ret, ep_len_acc = algo._store_traj(traj, last_v, ep_ret, ep_len_acc)
    out[name] = (algo.buf.get(), ep_ret, ep_len_acc,
                 {k: np.asarray(v, np.float64) for k, v in algo.logger.items()})
  (got, gret, glen, glog), (want, wret, wlen, wlog) = out['port'], out['jax']
  for k in ('act', 'ret', 'adv', 'logp'):
    _close(got[k], want[k], 1e-6)
  for k in want['obs']:
    _close(got['obs'][k], want['obs'][k], 0)
  _close(gret, wret, 0)
  _close(glen, wlen, 0)
  assert set(glog) == set(wlog) == {'EpRet', 'EpLen', 'success_rate'}
  for k in wlog:
    _close(glog[k], wlog[k], 0)


def test_fused_real_epoch_equals_step_loop(tmp_path):
  """rollout (VecEnv._core_step on device tensors) against get_av +
  VecEnv.step from the same states, goals, generator state and normals,
  over 7 steps at ep_len 3 (autoresets and goal resamples)."""
  T = 7
  tppo = PPO(tmain.parse(['--device=cpu', *ARGS, f'--logdir={tmp_path}',
                          '--ep_len=3', 'ppo']))
  venv = tppo.env
  venv.reset()
  A = tppo.act_space.shape[-1]
  eps = torch.randn((T, NUM_ENVS, A), generator=torch.Generator()
                    .manual_seed(3))
  start = (venv.states, dict(venv.goals), venv.gen.get_state())
  states, goals, traj, last_v = tppo.rollout(venv.states, venv.goals, T,
                                             eps=eps)
  venv.states, venv.goals = start[0], dict(start[1])
  venv.gen.set_state(start[2])
  o = venv._attach_goals(venv.env.observe(venv.states))
  loop = []
  for t in range(T):
    a, v, logp = tppo.get_av(o, eps=eps[t])
    sub = {k: val.numpy() for k, val in tppo._obs_subset(o).items()}
    o, rew, done, info = venv.step(a.numpy())
    loop.append((sub, a.numpy(), rew, v.numpy(), logp.numpy(), done,
                 np.array([i['success'] for i in info])))
  for i, field in enumerate(traj):
    want = [s[i] for s in loop]
    if isinstance(field, dict):
      for k in field:
        assert np.array_equal(field[k], np.stack([w[k] for w in want])), k
    else:
      assert np.array_equal(field, np.stack(want)), i
  assert traj[5].any() and traj[5][2].all()        # timeouts at step 3
  _close(last_v, tppo.get_av(o)[1], 0)
  for f in venv.states._fields:
    assert torch.equal(getattr(states, f), getattr(venv.states, f)), f
