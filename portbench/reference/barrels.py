"""Native barrels read back in plain NumPy: the codec's decoder (first frame
raw, then XOR deltas between consecutive bit-packed frames, MSB first along
W; data/native/barrelpack.cc) and the npz container."""
from __future__ import annotations

import io

import numpy as np


def unpack_lcd(packed, shape):
  """(..., T, frame_bytes) XOR-delta-coded packed frames -> (..., T, H, W)
  bool frames."""
  shape = tuple(int(x) for x in shape)
  frames = np.bitwise_xor.accumulate(np.asarray(packed, np.uint8), axis=-2)
  bits = np.unpackbits(frames, axis=-1)[..., :shape[-2] * shape[-1]]
  return bits.reshape(shape).astype(bool)


def read(blob):
  """The arrays of one native barrel's bytes, with `lcd` decoded to bool
  frames (the `lcd_packed` and `lcd_shape` entries replaced)."""
  with np.load(io.BytesIO(blob)) as z:
    out = {k: z[k] for k in z.files}
  out['lcd'] = unpack_lcd(out.pop('lcd_packed'), out.pop('lcd_shape'))
  return out
