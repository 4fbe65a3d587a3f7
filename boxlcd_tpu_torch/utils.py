"""Core utilities shared across boxlcd_tpu_torch.

The small utility vocabulary of the reference testbed
(reference: boxLCD/utils.py), written so that it works on numpy arrays and
torch tensors alike:
  - AttrDict            flat config object ("G")
  - A                   concise array constructor
  - mapto / rmapto      the [-1, 1] <-> physical-bounds mapping (obs contract)
  - NamedArray          dict-style access into a packed state vector
  - sortdict / subdlist / filtdict / nfiltdict / filtlist / nfiltlist
  - get_angle / make_rot  small geometry helpers
  - resolve_device      the device rule of the port's entry points
  - args_type           CLI flag coercion from a default value's type
  - NUM_SMS / MAX_SHARED_BYTES  the card's facts that launch geometry uses
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

NUM_SMS = 132                      # H100 SXM
MAX_SHARED_BYTES = 232448          # a block's shared memory on the H100


def resolve_device(device=None) -> torch.device:
  """The device an entry point runs on: the card unless the caller names
  another device. Raises when the card is asked for and there is none: the
  CPU runs only when asked for."""
  device = torch.device('cuda' if device is None else device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device is available; pass device="cpu" to '
                       'run on the CPU')
  return device


def set_tf32(enabled):
  """Allow or forbid TF32 for float32 matmuls and cuDNN convolutions, for
  the whole process. PyTorch allows it for convolutions by default, which
  on Hopper makes a float32 convolution a TF32 one; an entry point decides
  (`research.main` forbids it), never a model."""
  torch.backends.cuda.matmul.allow_tf32 = enabled
  torch.backends.cudnn.allow_tf32 = enabled


class AttrDict(dict):
  """dict with attribute access; the flat config object used everywhere."""
  __setattr__ = dict.__setitem__
  __getattr__ = dict.__getitem__


def args_type(default):
  """Return a coercion fn for CLI flags based on a default value's type."""
  if isinstance(default, bool):
    return lambda x: bool(['False', 'True'].index(x))
  if isinstance(default, int):
    return lambda x: float(x) if ('e' in x or '.' in x) else int(x)
  if isinstance(default, pathlib.Path):
    return lambda x: pathlib.Path(x).expanduser()
  return type(default)


class _ConciseArray:
  """A[1, 2, 3] -> np.array([1, 2, 3])."""

  def __getitem__(self, stuff):
    return np.array(stuff)


A = _ConciseArray()


# -- bounds mapping ----------------------------------------------------------
# Every observation / action dimension is normalized to [-1, 1] against its
# physical bounds (reference: boxLCD/utils.py:117-119). Plain arithmetic, so
# the same code maps numpy arrays and torch tensors.

def mapto(a, lowhigh):
  """[-1, 1] -> [low, high]."""
  lo, hi = lowhigh[0], lowhigh[1]
  return (a + 1.0) / 2.0 * (hi - lo) + lo


def rmapto(a, lowhigh):
  """[low, high] -> [-1, 1]."""
  lo, hi = lowhigh[0], lowhigh[1]
  return (a - lo) / (hi - lo) * 2.0 - 1.0


class NamedArray:
  """Dict-style access into a packed vector, with optional bounds mapping.

  Works on numpy arrays of shape (..., N). Mirrors the observation
  encoding contract of the reference (boxLCD/utils.py:33-101): reading a key
  un-normalizes from [-1,1] to its bounds; writing normalizes into [-1,1].
  """

  def __init__(self, arr, arr_info, do_map=True):
    self.arr = arr
    self.arr_info = arr_info
    self._keys = list(arr_info.keys())
    self.do_map = do_map

  def _idx(self, name):
    return self._keys.index(name)

  def todict(self):
    return {k: self[k] for k in self.arr_info}

  def __call__(self, key):
    return self[key]

  def __getitem__(self, key):
    if isinstance(key, str):
      val = self.arr[..., self._idx(key)]
      return mapto(val, self.arr_info[key]) if self.do_map else val
    if isinstance(key, (list, tuple)):
      val = np.stack([np.asarray(self.arr[..., self._idx(k)]) for k in key],
                     axis=-1)
      if self.do_map:
        return mapto(val, np.array([self.arr_info[k] for k in key]).T)
      return val
    raise NotImplementedError(key)

  def __setitem__(self, key, item):
    if isinstance(key, str):
      idx = self._idx(key)
      self.arr[..., idx] = (rmapto(item, self.arr_info[key]) if self.do_map
                            else item)
      return
    if isinstance(key, (list, tuple)):
      if self.do_map:
        bounds = np.array([self.arr_info[k] for k in key]).T
        item = rmapto(np.asarray(item), bounds)
      for j, k in enumerate(key):
        self.arr[..., self._idx(k)] = np.asarray(item)[..., j]
      return
    raise NotImplementedError(key)


# -- dict / list helpers -----------------------------------------------------

def subdict(d, subkeys):
  return {k: d[k] for k in subkeys}


def sortdict(x):
  return subdict(x, sorted(x))


def subdlist(d, subkeys):
  return [d[k] for k in subkeys]


def filtdict(d, phrase):
  return {k: d[k] for k in d if re.match(phrase, k) is not None}


def nfiltdict(d, phrase):
  return {k: d[k] for k in d if re.match(phrase, k) is None}


def filtlist(lst, phrase):
  return [x for x in lst if re.match(phrase, x) is not None]


def nfiltlist(lst, phrase):
  return [x for x in lst if re.match(phrase, x) is None]


# -- small geometry helpers --------------------------------------------------

def get_angle(sin, cos):
  return np.arctan2(sin, cos)


def make_rot(angle):
  c, s = np.cos(angle), np.sin(angle)
  return np.array([[c, -s], [s, c]])
