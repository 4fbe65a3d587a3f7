"""ctypes bindings for the native barrelpack codec (the port of
boxlcd_tpu/data/native/).

`barrelpack.cc` (the JAX package's source, unchanged) is built with g++ at
first use into the git-ignored `build/native/` beside the CUDA kernels'
`build/kernels/` (`_build.BUILD_DIR`); the library name carries a digest of
the source and flags, so an edited source rebuilds. A native barrel
(`*.tbarrel.npz`, uncompressed) stores the LCD frames bit-packed (MSB first,
np.packbits' layout) with an XOR delta between consecutive frames, as
`lcd_packed` + `lcd_shape`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from boxlcd_tpu_torch import _build

SRC = Path(__file__).resolve().parent / 'barrelpack.cc'
BUILD_DIR = _build.BUILD_DIR.parent / 'native'
CXX_FLAGS = ['-O3', '-shared', '-fPIC']
_lib = None


def _target() -> Path:
  digest = hashlib.sha256(SRC.read_bytes() + ' '.join(CXX_FLAGS).encode())
  return BUILD_DIR / f'libbarrelpack-{digest.hexdigest()[:16]}.so'


def build() -> Path:
  """Compile barrelpack.cc unless built; raises CalledProcessError on a
  failed build."""
  target = _target()
  if not target.exists():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    subprocess.check_call(['g++', *CXX_FLAGS, '-o', str(tmp), str(SRC)])
    os.replace(tmp, target)
  return target


def lib():
  global _lib
  if _lib is None:
    L = ctypes.CDLL(str(build()))
    buf, size = ctypes.c_char_p, ctypes.c_size_t
    L.pack_bits.argtypes = [buf, size, buf]
    L.pack_bits.restype = None
    L.unpack_bits.argtypes = [buf, size, buf]
    L.unpack_bits.restype = None
    L.xor_delta_encode.argtypes = [buf, size, size, buf]
    L.xor_delta_encode.restype = size
    L.xor_delta_decode.argtypes = [buf, size, size, buf]
    L.xor_delta_decode.restype = size
    _lib = L
  return _lib


def _cptr(a):
  return a.ctypes.data_as(ctypes.c_char_p)


def _encode(vids, T, frame_bytes):
  """(n_vids, T, frame_bytes) packed frames -> their XOR-delta encoding."""
  L = lib()
  vids = np.ascontiguousarray(vids, np.uint8)
  enc = np.empty_like(vids)
  for v in range(vids.shape[0]):
    L.xor_delta_encode(_cptr(vids[v]), T, frame_bytes, _cptr(enc[v]))
  return enc


def pack_frames(frames: np.ndarray) -> dict:
  """frames: (..., T, H, W) bool -> dict with packed bytes + shape."""
  frames = np.ascontiguousarray(frames, np.uint8)
  shape = frames.shape
  T = shape[-3]
  frame_bits = shape[-2] * shape[-1]
  if frame_bits % 8:
    raise ValueError('LCD frames must be byte-aligned (H*W % 8 == 0)')
  flat = frames.reshape(-1)
  packed = np.empty(flat.size // 8, np.uint8)
  lib().pack_bits(_cptr(flat), flat.size, _cptr(packed))
  n_vids = int(np.prod(shape[:-3])) if len(shape) > 3 else 1
  enc = _encode(packed.reshape(n_vids, T, frame_bits // 8), T,
                frame_bits // 8)
  return {'data': enc, 'shape': np.array(shape, np.int64)}


def pack_frames_packed(packed: np.ndarray, shape) -> dict:
  """Like pack_frames but for frames already bit-packed on the device
  (collect.pack_bits: MSB first along W, the layout pack_bits produces), so
  no unpack -> repack on the host. packed: (..., T, H, W//8) uint8; shape:
  the logical bool frame shape (..., T, H, W)."""
  shape = tuple(int(x) for x in shape)
  T = shape[-3]
  frame_bytes = shape[-2] * shape[-1] // 8
  n_vids = int(np.prod(shape[:-3])) if len(shape) > 3 else 1
  enc = _encode(packed.reshape(n_vids, T, frame_bytes), T, frame_bytes)
  return {'data': enc, 'shape': np.array(shape, np.int64)}


def unpack_frames(blob: dict) -> np.ndarray:
  """The inverse of pack_frames: -> (..., T, H, W) bool."""
  shape = tuple(int(x) for x in blob['shape'])
  T = shape[-3]
  frame_bytes = (shape[-2] * shape[-1] + 7) // 8
  enc = np.ascontiguousarray(blob['data'], np.uint8)
  L = lib()
  vids = np.empty_like(enc)
  for v in range(enc.shape[0]):
    L.xor_delta_decode(_cptr(enc[v]), T, frame_bytes, _cptr(vids[v]))
  flat = vids.reshape(-1)
  out = np.empty(flat.size * 8, np.uint8)
  L.unpack_bits(_cptr(flat), out.size, _cptr(out))
  return out.reshape(shape).astype(bool)
