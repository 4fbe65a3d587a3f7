"""The port's SAC (research/rl/sac.py) against the JAX package's, on the
CPU, from the same parameters (the flax init carried over by
`convert.load_flax`).

- One update (`mlp` and `cnn` nets) from the same parameters, targets
  (moved off the parameters), log_alpha and batch, with JAX's actor
  normals fed (the target actor's at obs2 from the key's first half, the
  actor's at obs from its second):
  parameters, target parameters, log_alpha and every metric within 1e-5 of
  optax's (torch Adam over the Q nets, the actor and log_alpha apart,
  against three optax states over the whole tree).
- `update_burst` equals the same updates in sequence from one generator
  state, as tests/test_rl.py holds JAX's burst to its sequence.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from boxlcd_tpu_torch.research.rl import main as tmain
from boxlcd_tpu_torch.research.rl.sac import SAC
from research import utils as jutils
from research.rl import main as jmain
from research.rl.sac import SAC as JSAC
from tests.test_torch_ppo import NullWriter, _close, _host

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

ARGS = ['--env=Luxo', '--lcd_base=16', '--num_envs=4', '--bs=16',
        '--hidden_size=32', '--nfilter=8', '--vel_iters=2', '--pos_iters=1',
        '--log_n=100000']


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
  for mod in (tutils, jutils):
    monkeypatch.setattr(mod, 'make_writer', lambda logdir: NullWriter())


def _batch(sac, n, seed):
  """A replay batch over the net's keys, made from a seed."""
  rng = np.random.RandomState(seed)
  A = sac.act_space.shape[-1]

  def obs():
    return {k: ((rng.rand(n, *v.shape[1:]) > 0.6).astype(np.float32)
                if k.endswith('lcd') else
                rng.uniform(-1, 1, (n, *v.shape[1:])).astype(np.float32))
            for k, v in sac.buf.obs.items()}
  return {'obs': obs(), 'obs2': obs(),
          'act': rng.uniform(-1, 1, (n, A)).astype(np.float32),
          'rew': rng.randn(n).astype(np.float32),
          'done': (rng.rand(n) < 0.3).astype(np.float32)}


@pytest.mark.parametrize('net', ['mlp', 'cnn'])
def test_update_matches_optax(tmp_path, net):
  argv = [*ARGS, f'--net={net}', f'--logdir={tmp_path}', 'sac']
  jsac = JSAC(jmain.parse(argv))
  tsac = SAC(tmain.parse(['--device=cpu', *argv]))
  # targets apart from the parameters, so the q-loss's next action shows
  # which actor drew it (the target one)
  rng = np.random.RandomState(0)
  jsac.target_params = jax.tree_util.tree_map(
      lambda p: p + 0.05 * rng.randn(*p.shape).astype(np.float32),
      jsac.params)
  load_flax(tsac.net, _host(jsac.params))
  load_flax(tsac.target, _host(jsac.target_params))
  _close(tsac.log_alpha, jsac.log_alpha, 0)
  batch = _batch(tsac, 16, seed=1)
  key = jax.random.PRNGKey(5)
  k1, k2 = jax.random.split(key)
  shape = batch['act'].shape
  eps = [torch.as_tensor(np.array(jax.random.normal(k, shape)))
         for k in (k1, k2)]
  (params, target, log_alpha, *_, jmet) = jsac._update(
      jsac.params, jsac.target_params, jsac.log_alpha, jsac.pi_state,
      jsac.q_state, jsac.a_state, jax.tree_util.tree_map(jnp.asarray, batch),
      key)
  met = tsac.update(jax.tree_util.tree_map(torch.as_tensor, batch), *eps)
  for module, want in ((tsac.net, params), (tsac.target, target)):
    want = flax_to_state_dict(_host(want))
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
      _close(got[k], want[k], 1e-5)
  _close(tsac.log_alpha, log_alpha, 1e-5)
  assert set(met) == set(jmet)
  for k in jmet:
    _close(met[k], jmet[k], 1e-5)
  assert float(met['loss/alpha']) != 0 and float(log_alpha) != np.log(0.1)


def test_update_burst_equals_sequential(tmp_path):
  tsac = SAC(tmain.parse(['--device=cpu', *ARGS, '--net=cnn',
                          f'--logdir={tmp_path}', 'sac']))
  n = 3
  batches = [_batch(tsac, 16, seed=s) for s in range(n)]
  stacked = jax.tree_util.tree_map(lambda *v: torch.as_tensor(np.stack(v)),
                                   *batches)
  opts = (tsac.pi_opt, tsac.q_opt, tsac.a_opt)
  state = copy.deepcopy((tsac.net.state_dict(), tsac.target.state_dict(),
                         tsac.log_alpha.detach(), tsac.gen.get_state(),
                         [o.state_dict() for o in opts]))
  burst = tsac.update_burst(stacked)
  after = (copy.deepcopy(tsac.net.state_dict()),
           copy.deepcopy(tsac.target.state_dict()), tsac.log_alpha.item())
  tsac.net.load_state_dict(state[0])
  tsac.target.load_state_dict(state[1])
  with torch.no_grad():
    tsac.log_alpha.copy_(state[2])
  tsac.gen.set_state(state[3])
  for opt, sd in zip(opts, state[4]):
    opt.load_state_dict(sd)
  for b in batches:
    seq = tsac.update(jax.tree_util.tree_map(torch.as_tensor, b))
  for got, want in ((tsac.net.state_dict(), after[0]),
                    (tsac.target.state_dict(), after[1])):
    for k in want:
      assert torch.equal(got[k], want[k]), k
  assert tsac.log_alpha.item() == after[2]
  for k in seq:
    assert torch.equal(seq[k], burst[k]), k
    assert torch.isfinite(seq[k])
