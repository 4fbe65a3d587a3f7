"""The config and normalisation helpers the reference's spec compiler and
env use (a frozen copy of boxlcd_tpu_torch/utils.py's, reference:
boxLCD/utils.py)."""
from __future__ import annotations

import re


class AttrDict(dict):
  """dict with attribute access."""
  __setattr__ = dict.__setitem__
  __getattr__ = dict.__getitem__


def mapto(a, lowhigh):
  """[-1, 1] -> [low, high]."""
  lo, hi = lowhigh[0], lowhigh[1]
  return (a + 1.0) / 2.0 * (hi - lo) + lo


def rmapto(a, lowhigh):
  """[low, high] -> [-1, 1]."""
  lo, hi = lowhigh[0], lowhigh[1]
  return (a - lo) / (hi - lo) * 2.0 - 1.0


def nfiltlist(lst, phrase):
  return [x for x in lst if re.match(phrase, x) is None]
