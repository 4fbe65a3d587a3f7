"""Model harness: module + optimizer + train step + checkpointing.

The port of research/nets/_base.py. A model owns a torch `nn.Module`
(`self.module`, built by the subclass's `build()`) and a loss
`loss_fn(batch, gen) -> (loss, metrics)`; the harness owns Adam after
optax's `clip_by_global_norm` + `adam`, the update, and checkpoints that
carry the config G beside the weights, the optimizer state, the step and
the generator state (mid-run resume). A model runs on its env's device.

Precision: the model leaves the process's TF32 flags alone; the entry
point sets them (`research.main` turns TF32 off with `utils.set_tf32`, so
float32 runs as float32 on the card too). bfloat16 is asked for explicitly
(`update(..., precision='bfloat16')`, the device-dataset trainer's
default), as an autocast around the forward and the loss.
"""
from __future__ import annotations

import contextlib
import os
import pickle
from pathlib import Path

import torch

from boxlcd_tpu_torch import utils


def global_norm(tensors):
  """optax.global_norm: the L2 norm of all entries together."""
  return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm_(grads, max_norm):
  """optax.clip_by_global_norm in place: scale by max_norm / norm only when
  norm >= max_norm (torch's clip_grad_norm_ adds 1e-6 to the norm). Returns
  the norm before clipping; no host sync."""
  norm = global_norm(grads)
  scale = torch.where(norm < max_norm, torch.ones_like(norm),
                      max_norm / norm)
  torch._foreach_mul_(grads, scale)
  return norm


def autocast(device, precision):
  """'float32' runs plain; 'bfloat16' autocasts matmuls and convolutions."""
  if precision == 'float32':
    return contextlib.nullcontext()
  if precision != 'bfloat16':
    raise ValueError(f'unknown precision {precision!r}')
  return torch.autocast(device.type, dtype=torch.bfloat16)


def to_device(batch, device):
  """dict of arrays -> dict of float32 tensors on `device` (uint8 stays
  uint8: packed latents)."""
  out = {}
  for k, v in batch.items():
    t = torch.as_tensor(v, device=device)
    out[k] = t if t.dtype == torch.uint8 else t.float()
  return out


class Net:
  name: str

  def __init__(self, env, G):
    self.env = env
    self.G = G
    self.name = self.__class__.__name__
    self.device = env.device   # the env's: the card unless G.device says
    self.gen = torch.Generator(device=self.device)
    self.gen.manual_seed(int(G.get('seed', 0)))

  # -- subclass contract ------------------------------------------------------
  # self.build() -> nn.Module (initialised on the CPU from G.seed)
  # self.loss_fn(batch, gen) -> (loss, metrics dict of scalar tensors)

  def _init(self):
    self.step = 0
    # the same seed gives the same initial weights on every device
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(int(self.G.get('seed', 0)))
      self.module = self.build()
    self.module.to(self.device)
    self.params = [p for p in self.module.parameters() if p.requires_grad]
    self.num_vars = sum(p.numel() for p in self.params)
    self.grad_clip = float(self.G.get('grad_clip', 10.0))
    # optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the root (eps_root 0)
    self.opt = torch.optim.Adam(self.params, lr=float(self.G.lr),
                                betas=(0.9, 0.999), eps=1e-8)

  def update(self, batch, gen, precision='float32'):
    """One clipped Adam step on `batch` (tensors on the device); returns
    the loss's metrics (detached tensors) with 'grad_norm', the norm before
    clipping."""
    self.opt.zero_grad(set_to_none=False)
    with autocast(self.device, precision):
      loss, metrics = self.loss_fn(batch, gen)
    loss.backward()
    grads = [p.grad for p in self.params]
    gnorm = clip_by_global_norm_(grads, self.grad_clip)
    self.opt.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics['grad_norm'] = gnorm
    return metrics

  def train_step(self, batch, dry=False):
    """One optimization step (reference: nets/_base.py:18-24); dry runs the
    loss only."""
    batch = to_device(batch, self.device)
    if dry:
      with torch.no_grad():
        _, metrics = self.loss_fn(batch, self.gen)
      return metrics
    metrics = self.update(batch, self.gen)
    self.step += 1
    return metrics

  def save(self, direc):
    """Full checkpoint: weights + optimizer state + step + generator state
    + config, written atomically (a torn pickle would poison every later
    auto-resume)."""
    direc = Path(direc)
    direc.mkdir(parents=True, exist_ok=True)
    path = direc / f'{self.name}.pkl'
    write_atomic(path, {'state_dict': self.cpu_state_dict(),
                        'opt_state': _to_cpu(self.opt.state_dict()),
                        'step': int(self.step),
                        'gen_state': self.gen.get_state(),
                        'G': dict(self.G)})
    print('SAVED MODEL', path)

  def cpu_state_dict(self):
    return {k: v.detach().cpu() for k, v in self.module.state_dict().items()}

  def save_frozen(self, direc):
    """The frozen net that `runners/trainer.load_arbiter` (and the learned
    env, for the object localizer) finds by its `*.frozen.pkl` name: the
    weights, G and the model's kind (its class name), written atomically.
    The port's own format, not the JAX package's flax bytes."""
    direc = Path(direc)
    direc.mkdir(parents=True, exist_ok=True)
    path = direc / f'{self.name}.frozen.pkl'
    write_atomic(path, {'state_dict': self.cpu_state_dict(),
                        'G': dict(self.G), 'kind': self.name})
    print('SAVED FROZEN', path)
    return path

  def load(self, direc, resume=True):
    """Restore the weights; with resume=True also the optimizer state, the
    step and the generator state."""
    path = Path(direc) / f'{self.name}.pkl'
    with open(path, 'rb') as f:
      blob = pickle.load(f)
    self.module.load_state_dict(blob['state_dict'])
    if resume:
      self.opt.load_state_dict(blob['opt_state'])
      self.step = int(blob['step'])
      self.gen.set_state(blob['gen_state'])
    print(f'LOADED {path}')

  @staticmethod
  def load_config(direc, name):
    """Read the config embedded in a checkpoint (for model reconstruction)."""
    with open(Path(direc) / f'{name}.pkl', 'rb') as f:
      blob = pickle.load(f)
    return utils.AttrDict(blob['G'])

  def evaluate(self, writer, batch, itr, arbiter=None):
    """Override in AE/VideoModel bases; default no-op."""
    return {}


def write_atomic(path, blob):
  """Pickle `blob` to `path` through a temporary file in the same folder:
  a torn pickle would poison every later load."""
  path = Path(path)
  tmp = path.with_name(f'.{path.name}.tmp')
  with open(tmp, 'wb') as f:
    pickle.dump(blob, f)
  os.replace(tmp, path)


def _to_cpu(obj):
  if isinstance(obj, torch.Tensor):
    return obj.detach().cpu()
  if isinstance(obj, dict):
    return {k: _to_cpu(v) for k, v in obj.items()}
  if isinstance(obj, list):
    return [_to_cpu(v) for v in obj]
  return obj
