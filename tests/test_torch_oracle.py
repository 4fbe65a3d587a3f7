"""The port's physics against the pybox2d oracle (boxlcd_tpu_torch.parity /
.oracle), at the 8/4 rows of tests/test_parity.py's TABLE and with its
floors: Dropbox and Bounce 50 steps here, Urchin and Luxo 30 in
tests/test_torch_oracle_robots.py, seeds (0, 1)
started from the JAX package's resets and stepped as one batch of 2 worlds
through the port's plain step. (The 180/60 rows, ~4-5 s a port step on one
CPU thread here, are research/scripts/parity_table.py's.)
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from boxlcd_tpu_torch import oracle
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.parity import env_parity
from tests.parity import make_env as jmake_env
from tests.test_parity import PASSIVE, SEEDS, TABLE

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

ROWS = [r for r in TABLE if r[1] == (8, 4)
        and r[0] in ('Dropbox', 'Bounce')]


@pytest.fixture
def box2d():
  if not oracle.HAVE_BOX2D:
    pytest.skip('pybox2d is not installed')


def _jax_resets(env_name, iters):
  """The JAX package's reset state of each seed (tests/parity.py's
  rollout_pair: env.seed(s); env.reset()), as one port batch."""
  env = jmake_env(env_name, {'vel_iters': iters[0], 'pos_iters': iters[1]})
  rows = []
  for s in SEEDS:
    env.seed(s)
    env.reset()
    rows.append(env.state)
  batch = jax.tree.map(lambda *x: jnp.stack(x), *rows)
  return physics.state_from_numpy(batch, 'cpu')


@pytest.mark.parametrize('env_name,iters,steps,min_teps,max_err,max_w1',
                         ROWS, ids=[r[0] for r in ROWS])
def test_divergence_floor(box2d, env_name, iters, steps, min_teps, max_err,
                          max_w1):
  m = env_parity(env_name, steps, seeds=SEEDS,
                 actuated=env_name not in PASSIVE, iters=iters,
                 states=_jax_resets(env_name, iters))
  print(env_name, iters, m)
  assert m['t_eps'] >= min_teps, f'{env_name}{iters}: t_eps {m}'
  assert m['mean_err'] <= max_err, f'{env_name}{iters}: mean_err {m}'
  assert m['w1_pose'] <= max_w1, f'{env_name}{iters}: w1 {m}'


def test_oracle_raises_without_box2d(monkeypatch):
  monkeypatch.setattr(oracle, 'HAVE_BOX2D', False)
  from boxlcd_tpu_torch.parity import make_env
  with pytest.raises(RuntimeError, match='pybox2d'):
    oracle.Box2DOracle(make_env('Dropbox'))
  from boxlcd_tpu_torch.research.scripts import parity_table
  with pytest.raises(RuntimeError, match='pybox2d'):
    parity_table.main(['--envs=Dropbox', '--steps=1', '--seeds=1'])
