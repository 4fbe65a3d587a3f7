"""Barrel dataset: random-window episode sampling for training.

The same in-memory numpy sampler as boxlcd_tpu/data/dataset.py (which
replaces the reference's torch IterableDataset + 12-worker DataLoader,
reference: research/data.py:123-179): barrels at reference scale fit in host
RAM, so the "loader" is one vectorized gather per batch. Reads npz barrels
and native ones (`*.tbarrel.npz`, frames through the barrelpack codec).
"""
from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np

BARREL_SIZE = int(1e3)  # episodes per shard (reference: research/data.py:21)


def barrel_files(folder):
  """The npz and native barrels of a folder, npz first."""
  folder = Path(folder)
  return sorted(folder.glob('*.barrel.npz')) \
      + sorted(folder.glob('*.tbarrel.npz'))


def unpack_native(data):
  """A loaded barrel dict with native `lcd_packed` + `lcd_shape` turned into
  full bool `lcd` frames (npz barrels pass through)."""
  if 'lcd_packed' in data:
    from boxlcd_tpu_torch.data import native
    data = dict(data)
    data['lcd'] = native.unpack_frames(
        {'data': data.pop('lcd_packed'), 'shape': data.pop('lcd_shape')})
  return data


class RolloutDataset:
  """Random (episode, window) batch sampler over barrel shards."""

  def __init__(self, barrel_path, window=int(1e9), infinite=True,
               refresh_data=False, seed=0):
    self.barrel_path = Path(barrel_path)
    self.window = window
    self.infinite = infinite
    self.refresh_data = refresh_data
    self.rng = np.random.RandomState(seed)
    self._cache = {}
    self._refresh()

  def _refresh(self):
    self.barrel_files = barrel_files(self.barrel_path)
    self.nbarrels = len(self.barrel_files)
    assert self.nbarrels > 0, f'no barrels found at {self.barrel_path}'

  def _load(self, path):
    if path not in self._cache:
      with np.load(path) as z:
        data = {k: z[k] for k in z.keys()}
      self._cache[path] = unpack_native(data)
    return self._cache[path]

  def batches(self, batch_size):
    """Yield dicts of float32 [bs, window, ...] arrays forever (or one pass)."""
    for ct in itertools.count():
      if self.infinite:
        f = self.barrel_files[self.rng.randint(self.nbarrels)]
        if self.refresh_data and ct % 10 == 0:
          self._refresh()
      else:
        f = self.barrel_files[ct % self.nbarrels]
      data = self._load(f)
      n_ep, ep_len = data['lcd'].shape[:2]
      w = min(self.window, ep_len)
      n_batches = n_ep // batch_size
      order = self.rng.permutation(n_ep)
      for b in range(n_batches):
        idx = order[b * batch_size:(b + 1) * batch_size]
        if ep_len > w:
          starts = self.rng.randint(0, ep_len - w, size=batch_size)
        else:
          starts = np.zeros(batch_size, np.int64)
        t_idx = starts[:, None] + np.arange(w)[None, :]
        batch = {k: v[idx[:, None], t_idx].astype(np.float32)
                 for k, v in data.items()}
        yield batch
      if not self.infinite and ct >= self.nbarrels - 1:
        break


def load_ds(G):
  """(train_iter, test_iter) of device-ready batches (reference: data.py:167)."""
  train = RolloutDataset(Path(G.datadir) / 'train', G.window,
                         refresh_data=G.get('refresh_data', 0))
  test = RolloutDataset(Path(G.datadir) / 'test', G.window, infinite=True)
  train_iter = train.batches(G.bs)
  test_iter = test.batches(G.bs)
  return _IterWithMeta(train_iter, train.nbarrels), \
      _IterWithMeta(test_iter, test.nbarrels)


class _IterWithMeta:
  def __init__(self, it, nbarrels):
    self._it = it
    self.nbarrels = nbarrels

  def __iter__(self):
    return self._it

  def __next__(self):
    return next(self._it)
