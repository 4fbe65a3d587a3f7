"""The port's dream_diag against the JAX script's tallies, on the CPU: one
fused dream epoch of the port's PPO (`lenv_rollout`) fed JAX's draws (the
pools, the action normals, the onestep uniforms and the pool indices, as
tests/test_torch_ppo_lenv.py feeds them) from JAX's start, and JAX's
`_lenv_rollout` from the same start: episodes ended, successes, the rate
and the mean reward, each as the JAX script tallies its trajectory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from boxlcd_tpu_torch.research.scripts import dream_diag
from tests.test_torch_ppo import _host
from tests.test_torch_ppo_lenv import (  # noqa: F401 (fixtures)
    LENV_STEPS, _jax_draws, lenv_pair, no_tensorboard)

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


def test_dream_diag_tallies_equal_jax(lenv_pair):
  jppo, tppo = lenv_pair
  tr = tppo.env
  key = jax.random.PRNGKey(5)
  draws = _jax_draws(jppo, key, LENV_STEPS, tr.lenv.model.z_size)
  B = tr.lenv.num_envs
  prompts = {k: v[:B] for k, v in draws['prompt_pool'].items()}
  wb = tppo._fresh_wb(prompts)
  goals = {f'goal:{k}': v[B:2 * B] for k, v in draws['goal_pool'].items()}
  jwb = {k: jnp.asarray(v.numpy()) for k, v in wb.items()}
  jgoals = {k: jnp.asarray(v.numpy()) for k, v in goals.items()}
  *_, jtraj, _ = jppo._lenv_rollout(
      jppo.params, jppo.env.lenv.model.params, jwb, jnp.int32(1),
      jnp.int32(0), jgoals, key, LENV_STEPS)
  # the JAX script's tally (research/scripts/dream_diag.py:77-81)
  _, _, rew, _, _, done, succ = [np.asarray(x) for x in _host(jtraj)]
  want = (succ.sum() / max(done.sum(), 1), int(done.sum()), int(succ.sum()),
          float(rew.mean()))
  tppo.steps_per_epoch = LENV_STEPS
  rate, eps, n_succ, rews = dream_diag.diagnose(
      tppo, 1, draws=[draws], state=(wb, 1, 0, goals))
  assert (eps, n_succ) == want[1:3] and eps > n_succ > 0
  assert rate == want[0]
  assert abs(rews[0] - want[3]) < 1e-5
