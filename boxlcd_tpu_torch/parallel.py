"""Data-parallel sharding over devices: the port's `--mesh=dpN`.

The counterpart of the JAX package's `Mesh` / `NamedSharding` use
(research/nets/_base.py, research/rl/ppo.py, boxlcd_tpu/data/collect.py,
__graft_entry__.py). One process drives N devices, as JAX's
single-controller mesh does: a batch splits evenly over the devices
(`Mesh.shard`), each device runs its slice on its own replica of the model
or env (`Mesh.replicate`, `env_on`), and the pieces come back to the first
device, the master (`Mesh.gather`).

On the card the devices are cuda:0..N-1 and a mesh larger than the card
count raises (`parse_mesh`). With `device='cpu'` they are N logical shards
of the CPU, so the shard and gather code runs without cards.

Random draws are made once, at the global batch's shape, from the caller's
generator, and sliced per shard: dpN sees exactly dp1's numbers. Code that
draws through `rand`, `randn` or `randint` below takes a shard's generator
(`ShardDraws.shard(i)`) in place of a torch.Generator; every such draw
must have the batch on its first axis (batch-major flattening allowed).
"""
from __future__ import annotations

import copy

import numpy as np
import torch


def parse_mesh(spec, device):
  """`--mesh` -> a Mesh, or None for ''. JAX's checks and messages: the
  spec must start with 'dp'; on the card there must be N devices (it never
  falls back to fewer). `device` is the entry point's: 'cpu' gives N
  logical CPU shards, a CUDA device cuda:0..N-1."""
  spec = str(spec or '')
  if not spec:
    return None
  if not spec.startswith('dp'):
    raise AssertionError(f'unsupported mesh {spec!r}')
  n = int(spec[2:])
  if n < 1:
    raise AssertionError(f'unsupported mesh {spec!r}')
  device = torch.device(device)
  if device.type == 'cpu':
    return Mesh([device] * n)
  have = torch.cuda.device_count() if torch.cuda.is_available() else 0
  if have < n:
    raise AssertionError(f'mesh {spec} needs {n} devices, have {have}')
  return Mesh([torch.device('cuda', i) for i in range(n)])


def _map(fn, x):
  """fn over the leaves of a dict / NamedTuple / tuple / list tree."""
  if isinstance(x, dict):
    return {k: _map(fn, v) for k, v in x.items()}
  if isinstance(x, tuple) and hasattr(x, '_fields'):
    return type(x)(*(_map(fn, v) for v in x))
  if isinstance(x, (tuple, list)):
    return type(x)(_map(fn, v) for v in x)
  return fn(x)


class Mesh:
  """N devices on one data-parallel axis; device 0 is the master."""

  def __init__(self, devices):
    self.devices = [torch.device(d) for d in devices]
    self.n = len(self.devices)

  def __repr__(self):
    return f'Mesh(dp={self.n}, devices={[str(d) for d in self.devices]})'

  @property
  def master(self):
    return self.devices[0]

  def check_divides(self, size, what):
    """Raise JAX's divisibility message: '{what} {size} must divide over
    {n} devices'."""
    if size % self.n:
      raise AssertionError(f'{what} {size} must divide over {self.n} devices')

  def shard(self, x, axis=0):
    """x (a tensor, or a dict / NamedTuple / tuple / list tree of them)
    split evenly along `axis`: a list of n trees, piece i on device i.
    Leaves that are not tensors are repeated. Raises unless every tensor's
    axis divides over the devices."""
    def piece(i):
      def cut(t):
        if not isinstance(t, torch.Tensor):
          return t
        size = t.shape[axis]
        if size % self.n:
          raise ValueError(f'axis {axis} of size {size} does not divide '
                           f'over {self.n} devices')
        k = size // self.n
        out = t.narrow(axis, i * k, k).to(self.devices[i])
        return out if out.is_contiguous() else out.contiguous()
      return cut
    return [_map(piece(i), x) for i in range(self.n)]

  def gather(self, xs, axis=0):
    """The inverse of shard: a list of n equal-structure trees -> one tree
    on the master, tensors (or numpy arrays) concatenated along `axis`;
    other leaves are taken from the first piece."""
    x = xs[0]
    if isinstance(x, dict):
      return {k: self.gather([y[k] for y in xs], axis) for k in x}
    if isinstance(x, (tuple, list)):
      parts = [self.gather([y[i] for y in xs], axis) for i in range(len(x))]
      return type(x)(*parts) if hasattr(x, '_fields') else type(x)(parts)
    if isinstance(x, torch.Tensor):
      return torch.cat([t.to(self.master) for t in xs], axis)
    if isinstance(x, np.ndarray):
      return np.concatenate(xs, axis)
    return x

  def replicate(self, module):
    """[module, copies of it on devices 1..n-1]: the master computes on
    the module itself, every other shard on its own copy (a copy on the
    same device too, for logical CPU shards). `refresh` brings the copies
    up to date."""
    return [module] + [copy.deepcopy(module).to(d) for d in self.devices[1:]]

  @staticmethod
  @torch.no_grad()
  def refresh(replicas):
    """Copy the master's parameters and buffers into the other replicas."""
    src = replicas[0].state_dict()
    for rep in replicas[1:]:
      for k, v in rep.state_dict().items():
        v.copy_(src[k])

  def envs(self, env):
    """The env on each device (the same object where the device is the
    env's own)."""
    return [env_on(env, d) for d in self.devices]


def env_on(env, device):
  """`env` on `device`: the env itself if it is there, else a shallow copy
  whose functional core (spec, device tables) is rebuilt on `device`."""
  device = torch.device(device)
  if env.device == device:
    return env
  from boxlcd_tpu_torch.envs.env import Env
  rep = copy.copy(env)
  Env.__init__(rep, env.world_def, env.G, device)
  return rep


# -- draws --------------------------------------------------------------------

class ShardDraws:
  """The random draws of one sharded call: shard 0 makes each draw at the
  global batch's shape from `gen` (in the order the unsharded code makes
  them), and every shard takes its rows. The shards run in order 0..n-1."""

  def __init__(self, gen, n):
    self.gen, self.n, self.made = gen, n, []

  def shard(self, i):
    """Shard i's generator: the caller's own when there is one shard."""
    return self.gen if self.n == 1 else ShardGen(self, i)


class ShardGen:
  """One shard's view of a ShardDraws; stands in for a torch.Generator in
  `rand`, `randn` and `randint`."""

  def __init__(self, draws, i):
    self.draws, self.i, self.count = draws, i, 0

  @property
  def device(self):
    return self.draws.gen.device

  def take(self, kind, shape, make, device):
    d = self.draws
    shape = tuple(int(s) for s in shape)
    if not shape:
      raise ValueError('a sharded draw needs a batch axis')
    if self.count == len(d.made):
      if self.i:
        raise RuntimeError(f'shard {self.i} drew before shard 0')
      d.made.append((kind, shape, make((shape[0] * d.n, *shape[1:]))))
    made_kind, made_shape, full = d.made[self.count]
    if (made_kind, made_shape) != (kind, shape):
      raise RuntimeError(f'shard {self.i} drew {kind} {shape} where shard '
                         f'0 drew {made_kind} {made_shape}')
    self.count += 1
    rows = shape[0]
    return full[self.i * rows:(self.i + 1) * rows].to(device)


def rand(shape, gen, device):
  """torch.rand(shape, generator=gen, device=device), or shard's rows."""
  if isinstance(gen, ShardGen):
    g = gen.draws.gen
    return gen.take('rand', shape, lambda s: torch.rand(
        s, generator=g, device=g.device), device)
  return torch.rand(shape, generator=gen, device=device)


def randn(shape, gen, device):
  """torch.randn(shape, generator=gen, device=device), or shard's rows."""
  if isinstance(gen, ShardGen):
    g = gen.draws.gen
    return gen.take('randn', shape, lambda s: torch.randn(
        s, generator=g, device=g.device), device)
  return torch.randn(shape, generator=gen, device=device)


def randint(high, shape, gen, device):
  """torch.randint(0, high, shape, generator=gen, device=device), or
  shard's rows."""
  if isinstance(gen, ShardGen):
    g = gen.draws.gen
    return gen.take(f'randint{high}', shape, lambda s: torch.randint(
        0, high, s, generator=g, device=g.device), device)
  return torch.randint(0, high, shape, generator=gen, device=device)
