"""The port's entry points (boxlcd_tpu_torch/graft_entry.py) on the CPU:

- `entry()`'s tiny FBT forward against the JAX __graft_entry__.entry()'s,
  from the JAX model's parameters (converted), within 1e-5;
- `dryrun_multichip(8, device='cpu')` on 8 logical CPU shards, at the
  production widths with BOXLCD_DRYRUN_WORLDS=64 and
  BOXLCD_DRYRUN_DREAM_ENVS=16, prints its three `[dryrun]` lines;
- without the cards (and no device='cpu') it raises JAX's assertion
  instead of falling back to a virtual mesh.
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from boxlcd_tpu_torch import graft_entry
from boxlcd_tpu_torch.research import utils as tutils
from boxlcd_tpu_torch.research.nets.convert import load_flax

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


class NullWriter:
  def add_scalar(self, *a, **k):
    pass

  def flush(self):
    pass


def test_entry_matches_jax():
  jfn, (jz, ja) = jge.entry()
  fn, (z, a) = graft_entry.entry(device='cpu')
  assert z.shape == jz.shape and a.shape == ja.shape
  # the JAX fn closes over its model: its parameters, converted
  jm = dict(zip(jfn.__code__.co_freevars,
                (c.cell_contents for c in jfn.__closure__)))['model']
  G = jm.G
  load_flax(fn.model.module, jax.tree_util.tree_map(np.asarray, jm.params))
  want = np.asarray(jax.jit(jfn)(jz, ja))
  with torch.no_grad():
    got = fn(z, a).numpy()
  assert got.shape == want.shape == (2, G.window, fn.model.z_size)
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_dryrun_multichip_on_cpu_shards(monkeypatch, capsys):
  monkeypatch.setenv('BOXLCD_DRYRUN_WORLDS', '64')
  monkeypatch.setenv('BOXLCD_DRYRUN_DREAM_ENVS', '16')
  monkeypatch.setattr(tutils, 'make_writer', lambda logdir: NullWriter())
  graft_entry.dryrun_multichip(8, device='cpu')
  lines = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith('[dryrun]')]
  assert len(lines) == 3
  assert lines[0].startswith('[dryrun] train step ok on 8 devices, loss=')
  assert np.isfinite(float(lines[0].rsplit('=', 1)[1]))
  assert lines[1] == ('[dryrun] sharded collect chunk ok: 64 worlds over 8 '
                      'devices (full obs consumed)')
  assert lines[2] == ('[dryrun] sharded dream-PPO epoch ok: 16 dream envs '
                      'over 8 devices (mesh=dp8)')


def test_dryrun_raises_without_the_cards():
  n = torch.cuda.device_count() + 1
  with pytest.raises(AssertionError,
                     match=f'mesh dp{n} needs {n} devices, have {n - 1}'):
    graft_entry.dryrun_multichip(n)
