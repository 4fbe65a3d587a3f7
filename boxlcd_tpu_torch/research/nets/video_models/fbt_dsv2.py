"""FBTDSV2: the FBT with a DeepSeek-V2 decoder for its transformer (MLA and
mixture-of-experts blocks, `nets/dsv2.py`), at DeepSeek-V2-Lite's published
widths unless the model's G carries `dsv2`, config.json keys to lay over
them (a dict or a JSON string; the CLI's config defines no such key).

Everything else is the FBT's: the frozen BVAE's codes as tokens, the
shift-right code and action embeddings, the Bernoulli head, `loss_fn`,
`onestep` with the carried codes and the one-frame encode's CUDA graph,
`encode_window`, and so `PPO.lenv_rollout`. The module is built in
`G.dsv2_precision` (bfloat16 by default, as the model is published) on the
model's device directly: at the published widths its 15.3 B parameters
would not pass through the host as float32.

On the card and outside autograd, `onestep`'s transformer is the replay
of a CUDA graph of the module at the window's shapes (`transformer`,
FBT's `_replay`, as the one-frame encode is): the 27 layers' ~1,100
launches a dream step cost the host more than the card takes to run
them. The tracer does not change the path: a replay has no per-layer
spans, so the spans `dsv2.*` are seen only in an eager call of the
module, and the MoE counters are added after each replay from the
layers' count buffers (`DSV2Module.count_moe`).

`sample` serves in the module's own precision (float32 codes and logits
around a bfloat16 transformer) and never makes `serving_net`'s float64
copy, which at these widths would take 122 GB. It has no latent cache
yet: `use_cache=True` runs the uncached path, the full forward at each
position, so both settings give the same draws.
"""
from __future__ import annotations

import torch

from boxlcd_tpu_torch.research.nets import dsv2
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT


class FBTDSV2(FBT):
  cached_sample = False

  def build(self):
    G = self.G
    cfg = dsv2.config(G.get('dsv2', ''))
    dtype = getattr(torch, G.get('dsv2_precision', 'bfloat16'))
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
      with torch.device(self.device):
        return dsv2.DSV2Module(cfg, self.block_size, self.z_size,
                               self.act_n)
    finally:
      torch.set_default_dtype(prev)

  def serving(self):
    """The module itself, codes and actions in float32."""
    return self.module, torch.float32

  def transformer(self, z, action):
    """The module's logits; on the card and outside autograd, from the
    replay of a CUDA graph of it at these shapes, captured again once a
    parameter changes. The logits are the graph's output buffer, valid
    until the next call."""
    if z.device.type != 'cuda' or torch.is_grad_enabled():
      return self.module(z, action)
    key = tuple((p.data_ptr(), p._version) for p in self.module.parameters())
    out = self._replay(('transformer', z.device, z.shape, action.shape),
                       key, self.module, (z, action))
    self.module.count_moe()
    return out
