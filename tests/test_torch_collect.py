"""The slice as a whole: the port's per-step collection vs boxlcd_tpu's.

The per-step rollout core (reset states + actions in, [B, T, ...] episode
tensors out) is fed the same JAX-reset states and numpy-made actions as a
Python loop of JAX `Env.observe` + `step_world_batch`, the body of
boxlcd_tpu's `make_rollout_fn`. full_state is held to tests/test_mega.py's Urchin bounds
(median per-world error and tail fraction: float-noise-limited, as contacts
amplify ~1e-7 op-order differences), frames to >= 99.9% equal pixels (a
body that moved by float noise can flip a pixel at a span edge).

A barrel written by the port's `fill_barrels` must load in boxlcd_tpu's
RolloutDataset with the npz layout of boxlcd_tpu/data/collect.py, from
either configuration. On the CPU the megakernel path (`make_mega_rollout_fn`)
and the per-step path give bit-identical episodes from one seed.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.data.dataset import RolloutDataset as JRolloutDataset
from boxlcd_tpu.engine import physics as jphys
from boxlcd_tpu.envs.env import Env as JEnv
from boxlcd_tpu_torch.data.collect import (
    fill_barrels, make_mega_rollout_fn, make_rollout_fn)
from boxlcd_tpu_torch.data.dataset import BARREL_SIZE, RolloutDataset
from boxlcd_tpu_torch.engine import physics
from boxlcd_tpu_torch.render import traj_raster
from boxlcd_tpu_torch.utils import AttrDict

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

B = 32
T = 8
# the module (the package's `collect` name is the entry-point function)
collect = importlib.import_module('boxlcd_tpu_torch.data.collect')
# tests/test_mega.py's Urchin bounds: (median, tail threshold, tail fraction)
MED, TAIL_AT, TAIL_FRAC = 1e-4, 5e-3, 0.03


def test_rollout_core_matches_jax_loop():
  G = {'ep_len': T}
  jenv = boxlcd_tpu.env_map['Urchin'](G)
  env = boxlcd_tpu_torch.env_map['Urchin'](G, device='cpu')
  keys = jax.random.split(jax.random.PRNGKey(0), B)
  states = jax.jit(jax.vmap(lambda k: JEnv.reset(jenv, k)))(keys)
  acts = np.random.default_rng(0).uniform(
      -1, 1, (T, B, env.act_size)).astype(np.float32)

  @jax.jit
  def jax_step(st, a):
    # boxlcd_tpu make_rollout_fn's scan body, batched; Env.step(...)[0] is
    # physics.step_world (its own observe is discarded)
    obs = jax.vmap(lambda s: JEnv.observe(jenv, s))(st)
    return obs, jphys.step_world_batch(jenv.spec, st, a)

  want = {'full_state': [], 'lcd': []}
  st = states
  for t in range(T):
    obs, st = jax_step(st, acts[t])
    for k in want:
      want[k].append(np.asarray(obs[k]))
  want = {k: np.stack(v, 1) for k, v in want.items()}       # [B, T, ...]

  fn, steps = make_rollout_fn(env)
  assert steps == T
  got = fn.core(physics.state_from_numpy(states, 'cpu'),
                torch.as_tensor(acts.transpose(1, 0, 2)))
  assert np.array_equal(got['action'].numpy(), acts.transpose(1, 0, 2))
  fs = got['full_state'].numpy()
  assert fs.shape == want['full_state'].shape and fs.dtype == np.float32
  err = np.abs(fs - want['full_state']).reshape(B, -1).max(1)   # per world
  assert np.median(err) < MED, np.median(err)
  assert (err > TAIL_AT).mean() < TAIL_FRAC, (err > TAIL_AT).mean()
  lcd = got['lcd'].numpy()
  assert lcd.shape == want['lcd'].shape and lcd.dtype == np.uint8
  same = (lcd.astype(bool) == want['lcd']).mean()
  assert same >= 0.999, same
  # o_0 is the reset pose, bit for bit
  assert np.array_equal(lcd[:, 0].astype(bool), want['lcd'][:, 0])


def test_fill_barrels_layout_loads_in_jax_dataset(tmp_path):
  T = 10                    # Dropbox episodes cut from 25 steps to 10
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': T}, device='cpu')
  jenv = boxlcd_tpu.env_map['Dropbox']({'ep_len': T})
  G = AttrDict(logdir=tmp_path)
  gen = torch.Generator().manual_seed(0)
  fill_barrels(env, 1, 'train', G, gen, batch_size=500)   # two dispatches
  files = sorted((tmp_path / 'train').glob('*.barrel.npz'))
  assert len(files) == 1 and files[0].name.endswith(f'-00000-{T}.barrel.npz')
  # boxlcd_tpu/data/collect.py's npz branch: action plus one entry per obs key
  want = {'action': ((BARREL_SIZE, T, jenv.act_size), np.float32)}
  for k, space in jenv.observation_space.items():
    want[k] = ((BARREL_SIZE, T, *space.shape), np.dtype(space.dtype))
  with np.load(files[0]) as z:
    got = {k: (z[k].shape, z[k].dtype) for k in z.keys()}
    lcd = z['lcd']
  assert got == want
  assert not lcd.all() and lcd.any()
  for ds in (JRolloutDataset(tmp_path / 'train', window=10, infinite=False),
             RolloutDataset(tmp_path / 'train', window=10, infinite=False)):
    batch = next(ds.batches(100))
    assert set(batch) == set(want)
    for k, (shape, _) in want.items():
      assert batch[k].shape == (100, 10, *shape[2:]), k
  # resume: the barrel on disk satisfies a rerun
  assert fill_barrels(env, 1, 'train', G, gen) is gen
  assert len(list((tmp_path / 'train').glob('*.barrel.npz'))) == 1


@pytest.mark.parametrize('env_name', ['Luxo', 'Object3'])
@pytest.mark.parametrize('pack_lcd', [True, False])
def test_mega_path_equals_per_step_path_on_cpu(env_name, pack_lcd):
  """One seed, both configurations: on the CPU both run the same float ops
  (the megakernel's plain version is the per-step physics), so every key of
  the episodes is bit-identical, with frames packed to bits or not."""
  env = boxlcd_tpu_torch.env_map[env_name]({'ep_len': 6}, device='cpu')
  fn_s, T = make_rollout_fn(env, pack_lcd=pack_lcd)
  fn_m, Tm = make_mega_rollout_fn(env, pack_lcd=pack_lcd)
  assert T == Tm == 6
  want = fn_s(torch.Generator().manual_seed(3), 8)
  got = fn_m(torch.Generator().manual_seed(3), 8)
  assert bool(got.pop('obs_ok'))          # the render tripwire is green
  assert set(got) == set(want)
  for k in want:
    assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert torch.equal(got[k], want[k]), k


def _mega_on_cpu(monkeypatch):
  """Make fill_barrels take the megakernel path on the CPU."""
  monkeypatch.setattr(collect, 'make_rollout_fn',
                      lambda env, pack_lcd=False: make_mega_rollout_fn(
                          env, pack_lcd=pack_lcd))


def test_fill_barrels_raises_on_a_corrupted_frame(tmp_path, monkeypatch):
  _mega_on_cpu(monkeypatch)
  plain = traj_raster.TrajRender.plain_rows

  def corrupted(self, *args):
    rows = plain(self, *args)
    rows[-1, -1, 0] ^= 1                  # one pixel of the last frame
    return rows

  monkeypatch.setattr(traj_raster.TrajRender, 'plain_rows', corrupted)
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': 4}, device='cpu')
  with pytest.raises(RuntimeError, match='refusing to write barrels'):
    fill_barrels(env, 1, 'train', AttrDict(logdir=tmp_path),
                 torch.Generator().manual_seed(0), batch_size=1000)
  assert not list((tmp_path / 'train').glob('*.npz'))


def test_fill_barrels_takes_the_per_step_path_on_cpu(tmp_path, monkeypatch):
  def no_mega(*args, **kwargs):
    raise AssertionError('the megakernel path ran on the CPU')

  monkeypatch.setattr(collect, 'make_mega_rollout_fn', no_mega)
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': 3}, device='cpu')
  fill_barrels(env, 1, 'train', AttrDict(logdir=tmp_path, collect_mega=1),
               torch.Generator().manual_seed(0), batch_size=1000)
  assert len(list((tmp_path / 'train').glob('*.barrel.npz'))) == 1


def test_mega_path_barrels_load_in_jax_dataset(tmp_path, monkeypatch):
  _mega_on_cpu(monkeypatch)
  T = 10
  env = boxlcd_tpu_torch.env_map['Dropbox']({'ep_len': T}, device='cpu')
  jenv = boxlcd_tpu.env_map['Dropbox']({'ep_len': T})
  fill_barrels(env, 1, 'train', AttrDict(logdir=tmp_path),
               torch.Generator().manual_seed(0), batch_size=500)
  files = sorted((tmp_path / 'train').glob('*.barrel.npz'))
  assert len(files) == 1
  with np.load(files[0]) as z:
    assert z['lcd'].shape == (BARREL_SIZE, T, jenv.lcd_h, jenv.lcd_w)
    assert z['lcd'].dtype == bool and z['action'].shape[:2] == (BARREL_SIZE, T)
  batch = next(JRolloutDataset(tmp_path / 'train', window=T,
                               infinite=False).batches(100))
  assert batch['lcd'].shape == (100, T, jenv.lcd_h, jenv.lcd_w)
  assert set(batch) == {'action', *jenv.observation_space.keys()}
