"""The port's native barrel codec (boxlcd_tpu_torch/data/native, the JAX
package's barrelpack.cc built by g++) and native barrels against
boxlcd_tpu's: the codec's bytes on the same frames (as tests/test_data.py:41
and :51 check the JAX codec), barrels written by either package loading in
the other's datasets, and fill_barrels' resume counting on native barrels.
"""
import jax
import numpy as np
import pytest
import torch

import boxlcd_tpu
import boxlcd_tpu_torch
from boxlcd_tpu.data import native as jnative
from boxlcd_tpu.data.collect import fill_barrels as jfill_barrels
from boxlcd_tpu.data.dataset import RolloutDataset as JRolloutDataset
from boxlcd_tpu.utils import AttrDict as JAttrDict
from boxlcd_tpu_torch.data import native
from boxlcd_tpu_torch.data.collect import (
    fill_barrels, make_rollout_fn, pack_bits, write_barrel_file)
from boxlcd_tpu_torch.data.dataset import RolloutDataset
from boxlcd_tpu_torch.data.device_dataset import DeviceDataset
from boxlcd_tpu_torch.utils import AttrDict

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)


@pytest.mark.parametrize('shape', [(4, 25, 16, 32), (5, 13, 16, 16),
                                   (7, 32, 32)])
def test_codec_bytes_equal_jax(shape):
  frames = np.random.RandomState(3).rand(*shape) > 0.7
  ours, ref = native.pack_frames(frames), jnative.pack_frames(frames)
  assert ours['data'].dtype == np.uint8
  assert (ours['data'] == ref['data']).all()
  assert (ours['shape'] == ref['shape']).all()
  assert ours['data'].nbytes * 8 == frames.size
  # device-packed input (collect.pack_bits' layout) gives the same bytes
  packed = pack_bits(torch.as_tensor(frames)).numpy()
  pre = native.pack_frames_packed(packed, frames.shape)
  assert (pre['data'] == ref['data']).all()
  assert (native.unpack_frames(ref) == frames).all()
  assert (jnative.unpack_frames(ours) == frames).all()


@pytest.fixture(scope='module')
def jax_native(tmp_path_factory):
  """A barrel folder written by boxlcd_tpu's fill_barrels, native format."""
  root = tmp_path_factory.mktemp('jax_native')
  env = boxlcd_tpu.env_map['Dropbox']()
  G = JAttrDict(logdir=root, num_envs=250, ep_len=env.G.ep_len,
                barrel_format='native')
  jfill_barrels(env, 1, 'train', G, jax.random.PRNGKey(0))
  return root / 'train'


def test_port_native_barrel_loads_in_jax(tmp_path):
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  fn, T = make_rollout_fn(env, pack_lcd=True)
  traj = {k: v.numpy() for k, v in fn(torch.Generator().manual_seed(0),
                                      16).items()}
  write_barrel_file(tmp_path, 0, T, env.lcd_w, traj, 'native')
  (f,) = tmp_path.glob('*.tbarrel.npz')
  with np.load(f) as z:
    assert set(z.keys()) == {'action', 'lcd_packed', 'lcd_shape',
                             'proprio', 'full_state'}
  frames = np.unpackbits(traj['lcd'], axis=-1).astype(bool)
  jds = JRolloutDataset(tmp_path, window=T, infinite=False)
  jdata = jds._load(jds.barrel_files[0])
  assert (jdata['lcd'] == frames).all()
  for k in ('action', 'proprio', 'full_state'):
    assert (jdata[k] == traj[k]).all()
  ds = RolloutDataset(tmp_path, window=T, infinite=False)
  assert (ds._load(ds.barrel_files[0])['lcd'] == frames).all()


def test_jax_native_barrel_loads_in_port(jax_native):
  jds = JRolloutDataset(jax_native, window=25, infinite=False)
  want = jds._load(jds.barrel_files[0])
  ds = RolloutDataset(jax_native, window=25, infinite=False)
  got = ds._load(ds.barrel_files[0])
  assert set(got) == set(want)
  for k in want:
    assert (got[k] == want[k]).all(), k
  batch = next(ds.batches(16))
  assert batch['lcd'].shape == (16, 25, 16, 16)
  # the device dataset holds the same frames, bit-packed
  dds = DeviceDataset(jax_native, device='cpu')
  assert dds.n_episodes == want['lcd'].shape[0]
  assert (dds.unpack_lcd(dds.data['lcd']).numpy() == want['lcd']).all()
  assert (dds.data['action'].numpy() == want['action']).all()


def test_fill_barrels_resumes_on_native(jax_native, tmp_path, capsys):
  env = boxlcd_tpu_torch.env_map['Dropbox'](device='cpu')
  train = tmp_path / 'train'
  train.mkdir()
  for f in jax_native.glob('*.tbarrel.npz'):
    (train / f.name).write_bytes(f.read_bytes())
  G = AttrDict(logdir=tmp_path, barrel_format='native')
  gen = torch.Generator().manual_seed(0)
  fill_barrels(env, 1, 'train', G, gen)
  assert 'already present, skipping' in capsys.readouterr().out
  assert len(list(train.glob('*'))) == 1
  # one more barrel: the native one on disk counts, one is collected
  fill_barrels(env, 2, 'train', G, gen, batch_size=1000)
  assert 'resuming, 1 barrels to go' in capsys.readouterr().out
  files = sorted(train.glob('*.tbarrel.npz'))
  assert len(files) == 2
  ds = RolloutDataset(train, infinite=False)
  assert all(ds._load(f)['lcd'].shape == (1000, 25, 16, 16) for f in files)
