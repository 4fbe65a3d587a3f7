"""Research utilities: logging, timers, the writer, small array helpers and
gif/video helpers (the port of research/utils.py). The logger keeps the
`dt/*` scalar names and rewrites hps.yaml on every dump."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import yaml


def flatten_first(x):
  """(A, B, ...) -> (A*B, ...) (reference: utils.py flatten_first)."""
  return x.reshape(-1, *x.shape[2:])


def _host(val):
  if isinstance(val, torch.Tensor):
    return val.detach().float().cpu().numpy()
  return np.asarray(val)


class AutoLogger:
  """Accumulate-then-mean logger (reference: defaultdict(list) pattern)."""

  def __init__(self):
    self._data = defaultdict(list)

  def __setitem__(self, key, val):
    self._data[key].append(_host(val))

  def update(self, metrics):
    for k, v in metrics.items():
      self[k] = v

  def items(self):
    return self._data.items()

  def clear(self):
    self._data.clear()


def dump_logger(logger, writer, itr, G):
  """Print + TB-write mean metrics, persist hps.yaml
  (reference: research/utils.py:63-85)."""
  print('=' * 30)
  print(f'itr {itr}')
  out = {}
  for key, val in logger.items():
    mean = float(np.mean([np.asarray(v).mean() for v in val]))
    out[key] = mean
    if writer is not None:
      writer.add_scalar(key, mean, itr)
    print(f'{key:40s} {mean:.4f}')
  if G is not None and G.get('logdir'):
    path = Path(G.logdir)
    path.mkdir(parents=True, exist_ok=True)
    dumpable = {k: (str(v) if isinstance(v, Path) else v) for k, v in G.items()}
    with open(path / 'hps.yaml', 'w') as f:
      yaml.dump(dumpable, f)
  print('=' * 30)
  logger.clear()
  return out


@contextmanager
def Timer(logger, key):
  """Wall-clock timer feeding `dt/*` metrics (reference: utils.py:184-200)."""
  start = time.time()
  yield
  logger[f'dt/{key}'] = time.time() - start


class NullWriter:
  """The writer's surface, writing nothing (no tensorboard installed)."""

  def add_scalar(self, *a, **k):
    pass

  def add_image(self, *a, **k):
    pass

  def add_video(self, *a, **k):
    pass

  def flush(self):
    pass


def make_writer(logdir):
  """TensorBoard writer, or a NullWriter if tensorboard is not installed."""
  try:
    from torch.utils.tensorboard import SummaryWriter
  except ImportError:
    return NullWriter()
  return SummaryWriter(str(logdir))


# -- media helpers (reference: research/utils.py:87-164, 203-247) -------------

def force_shape(out, N=4):
  """Tile a batch of images into an N-wide grid (reference:
  utils.py:110-131)."""
  out = np.asarray(out)
  bs = out.shape[0]
  rows = int(np.ceil(bs / N))
  pad = rows * N - bs
  if pad:
    out = np.concatenate([out, np.zeros((pad, *out.shape[1:]), out.dtype)])
  grid = out.reshape(rows, N, *out.shape[1:])
  return np.concatenate(np.concatenate(grid, axis=-2), axis=-1)


def combine_imgs(imgs, row=1, col=1):
  """(B, T, H, W) -> tiled (T, H*row, W*col) video strip
  (reference: utils.py:133-164)."""
  imgs = np.asarray(imgs)
  B, T = imgs.shape[:2]
  if B < row * col:
    raise ValueError(f'need {row * col} videos, have {B}')
  sel = imgs[:row * col].reshape(row, col, T, *imgs.shape[2:])
  return np.concatenate(np.concatenate(sel, axis=-2), axis=-1)


def write_gif(path, frames, fps=10, upscale=8):
  """(T, H, W) float/bool [0,1] -> animated gif (reference: utils.py:87-108);
  the frames as `<path>.npz` where Pillow is not installed. Returns the
  path written."""
  try:
    from PIL import Image
  except ImportError:
    np.savez_compressed(str(path) + '.npz', frames=np.asarray(frames))
    return str(path) + '.npz'
  frames = np.asarray(frames, np.float32)
  frames = frames.repeat(upscale, -2).repeat(upscale, -1)
  imgs = [Image.fromarray((255 * f).astype(np.uint8)) for f in frames]
  imgs[0].save(str(path), save_all=True, append_images=imgs[1:],
               duration=int(1000 / fps), loop=0)
  return str(path)


def write_image(path, img):
  """(H, W, 3) float [0, 1] -> a PNG; the image as `<path>.npz` where Pillow
  is not installed (write_gif's fallback). Returns the path written."""
  img = (255 * np.clip(np.asarray(img, np.float32), 0, 1)).astype(np.uint8)
  try:
    from PIL import Image
  except ImportError:
    np.savez_compressed(str(path) + '.npz', image=img)
    return str(path) + '.npz'
  Image.fromarray(img).save(str(path))
  return str(path)


def add_video(writer, tag, video, itr, fps=10):
  """Log (T,H,W), (B,T,H,W) gray or (B,T,3,H,W) RGB video to TB
  (reference: utils.py:203-247)."""
  if writer is None:
    return
  v = np.asarray(video, np.float32)
  if v.ndim == 3:
    v = v[None]
  if v.ndim == 4:
    v = v[:, :, None].repeat(3, 2)  # (B, T, C, H, W)
  writer.add_video(tag, torch.as_tensor((255 * v).astype(np.uint8)), itr,
                   fps=fps)
