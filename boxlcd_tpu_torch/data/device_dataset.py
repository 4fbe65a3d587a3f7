"""Device-resident dataset: the whole barrel store lives in device memory,
and training samples (episode, window) batches on the device.

The port of boxlcd_tpu/data/device_dataset.py: the host uploads the episodes
once (frames bit-packed, 1 bit a pixel), and every training step's batch is
a gather on the device, so a step moves no data over the host link. The JAX
package's K-step `lax.scan` dispatch is a Python loop of K steps here;
under `--mesh=dpN` each step's batch, sampled on the master, is sharded on
its batch axis by `Net.update` (JAX shards the (K, B, ...) chunk on axis
1: the same rows to the same devices).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.data.collect import unpack_bits
from boxlcd_tpu_torch.data.dataset import barrel_files, unpack_native

KEYS = ('lcd', 'proprio', 'action')     # what the world models train on


class DeviceDataset:
  """All episodes on the device; `sample(gen, bs, window)` gathers there."""

  def __init__(self, barrel_path, pack_lcd=True, device=None):
    self.device = utils.resolve_device(device)
    files = barrel_files(barrel_path)
    if not files:
      raise FileNotFoundError(f'no barrels at {barrel_path}')
    chunks = {k: [] for k in KEYS}
    self.lcd_w = None
    for f in files:
      with np.load(f) as z:
        data = unpack_native({k: z[k] for k in z.keys()})
      for k in KEYS:
        arr = data[k]
        if k == 'lcd':
          self.lcd_w = arr.shape[-1]
          if pack_lcd and arr.shape[-1] % 8 == 0:
            # 1 bit/px on the device and over the host link; sample()
            # unpacks the gathered windows on the device
            arr = np.packbits(arr.astype(bool), axis=-1)
          else:
            arr = arr.astype(np.uint8)
        else:
          arr = arr.astype(np.float32)
        chunks[k].append(arr)
    self.data = {k: torch.as_tensor(np.concatenate(v), device=self.device)
                 for k, v in chunks.items()}
    self.n_episodes = int(self.data['lcd'].shape[0])
    self.ep_len = int(self.data['lcd'].shape[1])

  def unpack_lcd(self, lcd):
    """Device-side np.unpackbits: (..., W/8) uint8 -> (..., W) uint8."""
    if self.lcd_w is None or lcd.shape[-1] == self.lcd_w:
      return lcd
    return unpack_bits(lcd, self.lcd_w)

  def sample(self, gen, bs, window, data=None):
    """Device-side batch: dict of (bs, window, ...) float32 tensors, the
    episodes and window starts drawn from `gen`. `data` overrides self.data
    (e.g. a {'z', 'action'} dict of precomputed latents; `z` stays uint8)."""
    data = self.data if data is None else data
    eps = torch.randint(0, self.n_episodes, (bs,), generator=gen,
                        device=self.device)
    max_start = max(self.ep_len - window, 0)
    starts = torch.randint(0, max_start + 1, (bs,), generator=gen,
                           device=self.device)
    t_idx = starts[:, None] + torch.arange(window, device=self.device)
    out = {}
    for k, arr in data.items():
      x = arr[eps[:, None], t_idx]
      if k == 'lcd':
        x = self.unpack_lcd(x)
      out[k] = x if k == 'z' else x.float()
    return out


def make_device_trainer(model, ds: DeviceDataset, bs, window, chunk,
                        matmul_precision='bfloat16'):
  """`run_chunk(gen, data)` runs `chunk` update steps, sampling every batch
  on the device, and returns the last step's metrics. matmul_precision
  'bfloat16' autocasts the forward and the loss to bfloat16; 'float32'
  runs plain."""

  def run_chunk(gen, data):
    for _ in range(chunk):
      batch = ds.sample(gen, bs, window, data)
      metrics = model.update(batch, gen, precision=matmul_precision)
    return metrics

  return run_chunk


def train_device(model, ds, total_itr, bs, window, chunk=100, log_every=None,
                 logger_cb=None, data=None, save_dir=None, save_every=300,
                 matmul_precision='bfloat16'):
  """Drive run_chunk until total_itr; returns the final metrics. `data`
  overrides ds.data (e.g. a {'z', 'action'} dict of precomputed latents).

  Resumes from model.step (set by Net.load), with the batch-sampling
  generator seeded from the start step so that a resumed run does not
  replay the batches it already consumed, and, when save_dir is given,
  checkpoints every save_every seconds."""
  data = ds.data if data is None else data
  step = make_device_trainer(model, ds, bs, window, chunk, matmul_precision)
  itr = int(getattr(model, 'step', 0))
  if itr:
    print(f'[device-train] resuming at step {itr}', flush=True)
  gen = torch.Generator(device=ds.device)
  gen.manual_seed(itr)
  base = itr
  metrics = {}
  t0 = time.time()
  last_save = t0
  while itr < total_itr:
    metrics = step(gen, data)
    itr += chunk
    model.step = itr
    if log_every and itr % log_every < chunk:
      rate = (itr - base) / (time.time() - t0)
      line = {k: float(v) for k, v in metrics.items()}
      print(f'[device-train] itr {itr} ({rate:,.0f} it/s) {line}', flush=True)
      if logger_cb:
        logger_cb(itr, line)
    if save_dir is not None and time.time() - last_save > save_every:
      model.save(save_dir)
      last_save = time.time()
  return metrics
