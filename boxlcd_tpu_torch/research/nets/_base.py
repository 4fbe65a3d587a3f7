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

`--mesh=dpN` (JAX: _base.py:76-104) shards each step's batch on its
first axis over per-device replicas of the module (`parallel.Mesh`): each
shard's loss, weighted by its share of the batch, runs backward on its
replica, the gradients are summed onto the master's, clipped there by
their global norm, and one Adam step on the master moves the weights,
which are copied to the replicas before the next sharded forward. The
loss's draws are made at the global batch's shape and sliced per shard,
so dpN computes dp1's numbers.
Metrics are the share-weighted sums of the shards' means; a metric that is
not such a mean comes from `gathered_metrics` over the whole batch.
"""
from __future__ import annotations

import contextlib
import copy
import os
import pickle
from pathlib import Path

import torch

from boxlcd_tpu_torch import parallel, utils


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
    # --mesh=dpN: the batch on 'dp'; replica 0 is this model itself
    self.mesh = parallel.parse_mesh(self.G.get('mesh', ''), self.device)
    self._replicas = None if self.mesh is None else \
        [self] + [self.replica(d) for d in self.mesh.devices[1:]]

  def replica(self, device):
    """A shallow copy of this model computing on its own copy of the
    module on `device`, with the frozen sub-models, the env and the tensor
    attributes moved there where they live elsewhere: one shard of a
    `--mesh` step."""
    device = torch.device(device)
    rep = copy.copy(self)
    rep.device = device
    rep.module = copy.deepcopy(self.module).to(device)
    rep.params = [p for p in rep.module.parameters() if p.requires_grad]
    for k, v in vars(self).items():
      if isinstance(v, Net) and v.device != device:
        setattr(rep, k, v.replica(device))
      elif isinstance(v, torch.Tensor):
        setattr(rep, k, v.to(device))
    rep.env = parallel.env_on(self.env, device)
    return rep

  def gathered_metrics(self, batch):
    """Metrics that are not a mean over equal shards of the batch,
    computed on the master over the whole batch (only under --mesh;
    unsharded, the loss's own metrics hold them)."""
    return {}

  def _sharded_loss(self, batch, gen, precision, backward):
    """The loss over the mesh: shard i's loss and metrics on replica i,
    weighted by its share of the batch (backward into the replica's
    gradients with `backward`); returns the summed metrics on the
    master."""
    mesh = self.mesh
    # the master's weights (stepped, loaded or set by hand) to the replicas
    parallel.Mesh.refresh([r.module for r in self._replicas])
    draws = parallel.ShardDraws(gen, mesh.n)
    shards = mesh.shard(batch)
    total = next(iter(batch.values())).shape[0]
    metrics = {}
    for i, (rep, b) in enumerate(zip(self._replicas, shards)):
      w = next(iter(b.values())).shape[0] / total
      with autocast(rep.device, precision):
        loss, m = rep.loss_fn(b, draws.shard(i))
      if backward:
        (loss * w).backward()
      for k, v in m.items():
        v = v.detach().to(mesh.master) * w
        metrics[k] = v if k not in metrics else metrics[k] + v
    with torch.no_grad():
      metrics.update(self.gathered_metrics(batch))
    return metrics

  def update(self, batch, gen, precision='float32'):
    """One clipped Adam step on `batch` (tensors on the device); returns
    the loss's metrics (detached tensors) with 'grad_norm', the norm before
    clipping. Under --mesh the batch is sharded (see the module's
    docstring)."""
    if self.mesh is not None:
      return self._update_sharded(batch, gen, precision)
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

  def _update_sharded(self, batch, gen, precision):
    reps = self._replicas
    for rep in reps:
      rep.module.zero_grad(set_to_none=False)
    metrics = self._sharded_loss(batch, gen, precision, backward=True)
    # the replicas' gradients summed onto the master's, in shard order
    for rep in reps[1:]:
      for p, q in zip(self.params, rep.params):
        p.grad.add_(q.grad.to(p.device))
    gnorm = clip_by_global_norm_([p.grad for p in self.params],
                                 self.grad_clip)
    self.opt.step()
    metrics['grad_norm'] = gnorm
    return metrics

  def train_step(self, batch, dry=False):
    """One optimization step (reference: nets/_base.py:18-24); dry runs the
    loss only (sharded too, under --mesh)."""
    batch = to_device(batch, self.device)
    if dry:
      with torch.no_grad():
        if self.mesh is not None:
          return self._sharded_loss(batch, self.gen, 'float32',
                                    backward=False)
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
