"""The port's package boundary and its spec compiler vs boxlcd_tpu's.

boxlcd_tpu_torch must import with neither JAX nor the JAX package (it keeps
its own copies of the pure-numpy modules), and its `compile_world` must give
exactly the arrays boxlcd_tpu's does, for every env of the zoo.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu_torch.engine.spec import compile_world

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'boxlcd_tpu_torch'
FORBIDDEN = ('jax', 'flax', 'boxlcd_tpu', 'research')


def test_import_pulls_in_no_jax():
  code = (
      'import sys, pkgutil, importlib, boxlcd_tpu_torch\n'
      'for m in pkgutil.walk_packages(boxlcd_tpu_torch.__path__, '
      "'boxlcd_tpu_torch.'):\n"
      '  importlib.import_module(m.name)\n'
      "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'boxlcd_tpu', 'research'))\n"
      'print(len(list(pkgutil.walk_packages(boxlcd_tpu_torch.__path__))), bad)\n'
      'assert not bad, bad\n')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize('path', sorted(
    [p for p in PORT.rglob('*.py')] + [ROOT / 'chip_smoke.py']),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
  tree = ast.parse(path.read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
      names = [node.module or '']
    else:
      continue
    for name in names:
      assert name.split('.')[0] not in FORBIDDEN, \
          f'{path.name}:{node.lineno} imports {name}'


@pytest.mark.parametrize('env_name', sorted(boxlcd_tpu.env_map))
def test_compile_world_matches_jax(env_name):
  env = boxlcd_tpu.env_map[env_name]({})
  ours = compile_world(env.world_def, env.G)
  ref = env.spec
  assert ours.vel_iters == ref.vel_iters and ours.pos_iters == ref.pos_iters
  for f in dataclasses.fields(ref):
    a, b = getattr(ref, f.name), getattr(ours, f.name)
    if isinstance(a, np.ndarray):
      assert a.dtype == b.dtype and a.shape == b.shape, f.name
      assert np.array_equal(a, b), f.name
    else:
      assert a == b, f.name


def test_port_zoo_matches_jax_zoo():
  assert sorted(boxlcd_tpu_torch.env_map) == sorted(boxlcd_tpu.env_map)
  for name, cls in boxlcd_tpu.env_map.items():
    assert dict(boxlcd_tpu_torch.env_map[name].ENV_DG) == dict(cls.ENV_DG), name
