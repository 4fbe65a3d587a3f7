"""The port's bench (boxlcd_tpu_torch/bench.py) on the CPU, and where the
port writes its evidence:

- the `jnp` line at BENCH_WORLDS=8, BENCH_STEPS=2 prints one JSON line with
  the root bench.py's keys and metric name (plus the card field);
- a chunk's consumed sum (mega: the megakernel's plain rollout, the
  trajectory raster's plain rows and observe_pose; jnp and sub: the step
  and Env.observe) equals the sum of the port's Env.observe over the same
  stepped states, from the same actions;
- BENCH_MATRIX=1 writes the port's matrix (logs/evidence/torch/) and
  leaves the root BENCH_MATRIX.json and the JAX evidence byte for byte as
  they were; so does an eval_policy run of the port.
The kernels' chunks are held to the jnp chunk on the card in
tests/test_torch_cuda.py.
"""
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import bench
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.rl import main as tmain
from boxlcd_tpu_torch.research.scripts import eval_policy

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# the root bench.py's JSON keys
KEYS = {'metric', 'value', 'unit', 'vs_baseline'}


def _digests():
  """sha256 of the root BENCH_MATRIX.json and every JAX evidence file."""
  root = REPO / 'logs' / 'evidence'
  files = [REPO / 'BENCH_MATRIX.json'] + sorted(
      p for p in root.rglob('*') if p.is_file()
      and 'torch' not in p.relative_to(root).parts
      and '__pycache__' not in p.parts)
  return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def test_jnp_line(monkeypatch, capsys):
  for k, v in {'BENCH_WORLDS': '8', 'BENCH_STEPS': '2', 'BENCH_SOLVER': 'jnp',
               'BENCH_PIPELINE': '1'}.items():
    monkeypatch.setenv(k, v)
  rec = bench.main(device='cpu')
  lines = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith('{')]
  assert len(lines) == 1 and json.loads(lines[0]) == rec
  assert KEYS <= set(rec) and rec['metric'] == 'env_steps_per_sec_urchin_8'
  assert rec['unit'] == 'env-steps/s' and rec['value'] > 0
  assert rec['solver'] == 'jnp' and rec['card'] == 'cpu'
  assert rec['vs_baseline'] == round(
      rec['value'] / bench.REFERENCE_STEPS_PER_SEC, 2)


@pytest.mark.parametrize('kind', ['mega', 'jnp', 'sub'])
def test_chunk_consumes_every_observation(kind):
  T, B = 3, 4
  env = bench.make_env('Urchin', 2, 1, 'cpu')
  gen = torch.Generator().manual_seed(1)
  states = Env.reset(env, gen, B)
  acts = torch.rand((T, B, env.act_size), generator=gen) * 2 - 1
  final, consumed = bench.make_chunk(env, kind, T)(states, acts)
  want, st = 0.0, states
  for t in range(T):
    st = physics.step_world_batch(env.spec, st, acts[t])
    obs = Env.observe(env, st)
    want += sum(float(obs[k].double().sum())
                for k in ('lcd', 'full_state', 'proprio'))
  np.testing.assert_allclose(float(consumed), want, rtol=1e-6)
  torch.testing.assert_close(final.c, st.c, atol=1e-5, rtol=0)


def test_port_evidence_never_lands_on_a_jax_file(tmp_path, monkeypatch):
  assert bench.MATRIX_PATH == (REPO / 'logs' / 'evidence' / 'torch'
                               / 'BENCH_MATRIX.json')
  assert eval_policy.EVIDENCE_DIR == REPO / 'logs' / 'evidence' / 'torch'
  before = _digests()
  # the port's matrix (one row) and headline, into a copy of the folder
  evidence = tmp_path / 'logs' / 'evidence'
  shutil.copytree(REPO / 'logs' / 'evidence', evidence,
                  ignore=shutil.ignore_patterns('torch', '__pycache__'))
  monkeypatch.setattr(bench, 'MATRIX_PATH',
                      evidence / 'torch' / 'BENCH_MATRIX.json')
  monkeypatch.setattr(bench, 'MATRIX_CONFIGS', ((2, 1, 'auto', 0.0),
                                                (2, 1, 'jnp', 0.0)))
  for k, v in {'BENCH_WORLDS': '4', 'BENCH_STEPS': '1', 'BENCH_ENV': 'Dropbox',
               'BENCH_MATRIX': '1', 'BENCH_MATRIX_ENVS': 'Dropbox',
               'BENCH_PIPELINE': '1'}.items():
    monkeypatch.setenv(k, v)
  bench.main(device='cpu')
  (row,) = json.loads(bench.MATRIX_PATH.read_text())
  assert row['env'] == 'Dropbox' and row['solver'] == 'jnp'
  # a port eval_policy run of a one-epoch PPO checkpoint
  monkeypatch.setattr(tutils, 'make_writer', lambda logdir: _Null())
  logdir = tmp_path / 'run' / 'ppo'
  tmain.main(['--env=Luxo', '--lcd_base=16', '--vel_iters=2',
              '--pos_iters=1', '--device=cpu', '--num_envs=4', '--ep_len=2',
              '--hidden_size=16', '--bs=8', '--log_n=100000',
              f'--logdir={logdir}', '--steps_per_epoch=8',
              '--total_steps=8', '--train_pi_iters=1', '--train_v_iters=1',
              'ppo'])
  monkeypatch.setattr(eval_policy, 'ITERS', 1)
  monkeypatch.setattr(eval_policy, 'N_ENVS', 4)
  monkeypatch.setattr(eval_policy, 'EVIDENCE_DIR', evidence / 'torch')
  eval_policy.main([f'--logdir={logdir}', '--device=cpu', 'ppo'])
  assert len(list((evidence / 'torch').glob('eval_Luxo_ppo_*.json'))) == 1
  # the copies of the JAX files, and the repo's own, as they were
  for p, digest in before.items():
    if p.parent == REPO / 'logs' / 'evidence':
      copy = evidence / p.name
      assert hashlib.sha256(copy.read_bytes()).hexdigest() == digest, p
  assert _digests() == before


class _Null:
  def add_scalar(self, *a, **k):
    pass

  def flush(self):
    pass
