"""Carry flax parameters into the port's modules.

`flax_to_state_dict(params)` turns a flax parameter tree, given as nested
dicts of numpy arrays (for example `jax.tree_util.tree_map(np.asarray,
params)`), into a `state_dict` for the port's module of the same model
(`BVAEModule`, `FBTModule`, or a block of `common.py`). The port's
submodules carry the flax names, so the mapping is by name:
  - Dense `kernel` (in, out)      -> Linear `weight` (out, in)
  - Conv `kernel` HWIO            -> Conv2d `weight` OIHW
  - ConvTranspose `kernel` HWIO   -> ConvTranspose2d `weight` (in, out,
    kh, kw), flipped in both spatial axes (`common.ConvTranspose`); the
    rule is keyed on the module's flax name, `ConvTranspose_<i>`
  - LayerNorm/GroupNorm `scale`   -> `weight`
  - `bias`, `embedding`, `pos_emb` and other raw parameters (the RL
    PPOActor's `log_std`) as they are;
  - a GRUCell, the subtree of Dense kernels `ir iz in hr hz hn`, ->
    `common.GRUCell`'s `weight_ih` [ir; iz; in] and `weight_hh` [hr; hz;
    hn], each kernel transposed, `bias_ih` [b_ir; b_iz; b_in] and
    `bias_hn` (the order of the gates is torch.gru_cell's: r, z, n).
The RL nets (`research/rl/nets.py`) map by the same rules: their Dense
names (`goal_preproc`, `BaseMLP_0/Dense_<i>`, `SACFeatures_0`, ...) are
the submodules' names, and `ImgCNN` flattens its conv features in flax's
(h, w, c) order, so the Dense after it takes the flax kernel as it is.
Only this direction is provided. Loading a JAX checkpoint (`.pkl`) or a
JAX frozen arbiter (`*.frozen.pkl`, flax msgpack bytes) would need flax's
msgpack serialization and is not supported: the port's frozen arbiters
are its own (`autoencoders/_base.save_frozen`).
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(module, name, value):
  value = np.asarray(value)
  if name == 'kernel':
    if value.ndim == 2:
      return 'weight', value.T
    if value.ndim == 4 and module.startswith('ConvTranspose_'):
      return 'weight', value[::-1, ::-1].transpose(2, 3, 0, 1)
    if value.ndim == 4:
      return 'weight', value.transpose(3, 2, 0, 1)
    raise ValueError(f'kernel of rank {value.ndim}')
  if name == 'scale':
    return 'weight', value
  return name, value


GRU_GATES = ('ir', 'iz', 'in', 'hr', 'hz', 'hn')


def _gru(tree):
  """A flax GRUCell's six Dense kernels -> common.GRUCell's parameters."""
  k = {g: np.asarray(tree[g]['kernel']).T for g in GRU_GATES}
  return {'weight_ih': np.concatenate([k['ir'], k['iz'], k['in']]),
          'weight_hh': np.concatenate([k['hr'], k['hz'], k['hn']]),
          'bias_ih': np.concatenate([np.asarray(tree[g]['bias'])
                                     for g in ('ir', 'iz', 'in')]),
          'bias_hn': np.asarray(tree['hn']['bias'])}


def flax_to_state_dict(params):
  """flax params (optionally under a top-level 'params') -> state_dict."""
  if set(params) == {'params'}:
    params = params['params']
  out = {}

  def walk(tree, prefix, module):
    if set(tree) == set(GRU_GATES):
      for key, arr in _gru(tree).items():
        out[prefix + key] = torch.as_tensor(np.array(arr, order='C'))
      return
    for name, value in tree.items():
      if isinstance(value, dict):
        walk(value, f'{prefix}{name}.', name)
      else:
        key, arr = _leaf(module, name, value)
        out[prefix + key] = torch.as_tensor(np.array(arr, order='C'))

  walk(params, '', '')
  return out


def load_flax(module, params):
  """Load flax params into `module` in place (every key must match)."""
  device = next(module.parameters()).device
  module.load_state_dict({k: v.to(device) for k, v in
                          flax_to_state_dict(params).items()})
  return module
