"""The port's physics against the pybox2d oracle: the 8/4 rows of
tests/test_parity.py's TABLE for the robots, Urchin and Luxo (30 steps),
as tests/test_torch_oracle.py holds the passive worlds.
"""
import pytest
import torch

from boxlcd_tpu_torch.parity import env_parity
from tests.test_parity import PASSIVE, SEEDS, TABLE
from tests.test_torch_oracle import _jax_resets, box2d  # noqa: F401

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

ROWS = [r for r in TABLE if r[1] == (8, 4)
        and r[0] in ('Urchin', 'Luxo')]


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
