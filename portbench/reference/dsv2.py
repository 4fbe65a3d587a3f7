"""A frozen copy of the port's plain DeepSeek-V2 reference
(boxlcd_tpu_torch/research/nets/reference/dsv2_ref.py), held here so that
a change to the program cannot move what decides `correct`.

The plain reference of the DeepSeek-V2 world model (`FBTDSV2`'s
transformer), written out from the published layer equations
(DeepSeek-V2's `modeling_deepseek.py`) as plain torch functions of a dict
of weights by the port's parameter names, so that one state dict serves
both. It imports nothing of the port and no kernel: every product is a
plain matmul, the routed experts a Python loop over experts, attention the
full window's scores.

Everything is computed in float32 (weights given in another dtype are cast
as they are read), with TF32 off for the duration of a call
(`torch.backends.cuda.matmul.allow_tf32`, `torch.backends.cudnn.allow_tf32`
False), so a float32 product on a card is a float32 product.

DeepSeek-V2-Lite's choices only: softmax routing, greedy top-k without
renormalisation, uncompressed queries (`q_lora_rank` null).

The world model's two ends are the FBT's, not the language model's: the
codes (B, T, z_size) and actions (B, T, act_n) shifted right, `embed` and
`cond_in` (hidden / 2 each) concatenated, no position embedding (rotary
positions), a final RMSNorm and a Bernoulli head `dist_head.Dense_0` over
the codes. The MoE layer takes the range of experts it holds, as the port's
does: it routes over all experts and adds its own experts' part.

`rounded(dtype)`: inside it every matmul input is rounded through `dtype`
(float8_e4m3fn: the benchmark's control, a lower precision than the
model's bfloat16) and back to float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_ROUND = {'dtype': None}

# the config.json keys that shape the model, as a cell's configuration
# file holds them at its top level (`model_config`)
KEYS = ('hidden_size', 'intermediate_size', 'moe_intermediate_size',
        'n_routed_experts', 'n_shared_experts', 'num_experts_per_tok',
        'first_k_dense_replace', 'moe_layer_freq', 'num_hidden_layers',
        'num_attention_heads', 'q_lora_rank', 'kv_lora_rank',
        'qk_nope_head_dim', 'qk_rope_head_dim', 'v_head_dim', 'rms_norm_eps',
        'rope_theta', 'rope_scaling', 'norm_topk_prob',
        'routed_scaling_factor', 'scoring_func', 'topk_method')


def model_config(cell_cfg):
  """The model's configuration from a cell's configuration file: its
  config.json keys (`KEYS`, each required) from the file's top level."""
  return {k: cell_cfg[k] for k in KEYS}


@contextlib.contextmanager
def rounded(dtype):
  """Every matmul input rounded through `dtype` inside the block."""
  prev = _ROUND['dtype']
  _ROUND['dtype'] = dtype
  try:
    yield
  finally:
    _ROUND['dtype'] = prev


@contextlib.contextmanager
def no_tf32():
  m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = m
    torch.backends.cudnn.allow_tf32 = c


def _in(t):
  t = t.float()
  d = _ROUND['dtype']
  return t if d is None else t.to(d).float()


def mm(a, b):
  return _in(a) @ _in(b)


def linear(p, name, x):
  y = mm(x, p[f'{name}.weight'].float().T)
  b = p.get(f'{name}.bias')
  return y if b is None else y + b.float()


def rms_norm(p, name, x, eps):
  x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
  return p[f'{name}.weight'].float() * x


def mscale(scale, m):
  return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_tables(cfg, T, device=None):
  """YaRN (cos, sin), (T, qk_rope_head_dim): frequencies base^(-2i/d),
  divided by `factor` past the ramp from floor(d_c(beta_fast)) to
  ceil(d_c(beta_slow)), d_c(r) = d ln(orig / (2 pi r)) / (2 ln base),
  blended linearly across it; scaled by mscale(mscale) /
  mscale(mscale_all_dim)."""
  d, base = cfg['qk_rope_head_dim'], float(cfg['rope_theta'])
  rs = cfg['rope_scaling']
  i = torch.arange(d // 2, dtype=torch.float64)
  freq = base ** (-2 * i / d)
  dc = lambda r: d * math.log(  # noqa: E731
      rs['original_max_position_embeddings'] / (2 * math.pi * r)) / \
      (2 * math.log(base))
  low = max(math.floor(dc(rs['beta_fast'])), 0)
  high = min(math.ceil(dc(rs['beta_slow'])), d - 1)
  ramp = ((i - low) / max(high - low, 0.001)).clamp(0, 1)
  freq = freq / rs['factor'] * ramp + freq * (1 - ramp)
  ang = torch.arange(T, dtype=torch.float64)[:, None] * freq[None]
  ang = torch.cat([ang, ang], -1)
  s = mscale(rs['factor'], rs['mscale']) / mscale(rs['factor'],
                                                  rs['mscale_all_dim'])
  return ((ang.cos() * s).float().to(device),
          (ang.sin() * s).float().to(device))


def rope(x, cos, sin):
  """The published interleaved pairs (x0, x1), (x2, x3), ... as evens then
  odds, then x cos + rotate_half(x) sin."""
  d = x.shape[-1]
  x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
  half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
  return x * cos + half * sin


def attention_scale(cfg):
  rs = cfg['rope_scaling']
  m = mscale(rs['factor'], rs['mscale_all_dim'])
  return (cfg['qk_nope_head_dim'] + cfg['qk_rope_head_dim']) ** -0.5 * m * m


def mla(p, name, x, cfg, cos, sin):
  B, T, _ = x.shape
  nh, dn = cfg['num_attention_heads'], cfg['qk_nope_head_dim']
  dr, dv, r = cfg['qk_rope_head_dim'], cfg['v_head_dim'], \
      cfg['kv_lora_rank']
  eps = cfg['rms_norm_eps']
  q = linear(p, f'{name}.q_proj', x).reshape(B, T, nh, dn + dr)
  q = q.transpose(1, 2)
  ckv = linear(p, f'{name}.kv_a_proj_with_mqa', x)
  c, k_pe = ckv[..., :r], ckv[..., r:]
  kv = linear(p, f'{name}.kv_b_proj', rms_norm(p, f'{name}.kv_a_layernorm',
                                               c, eps))
  kv = kv.reshape(B, T, nh, dn + dv).transpose(1, 2)
  q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], -1)
  k_pe = rope(k_pe, cos, sin)[:, None].expand(B, nh, T, dr)
  k = torch.cat([kv[..., :dn], k_pe], -1)
  v = kv[..., dn:]
  att = mm(q, k.transpose(-1, -2)) * attention_scale(cfg)
  mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
  att = att.masked_fill(~mask, float('-inf')).softmax(-1)
  y = mm(att, v).transpose(1, 2).reshape(B, T, nh * dv)
  return linear(p, f'{name}.o_proj', y)


def swiglu(p, name, x):
  g = linear(p, f'{name}.gate_proj', x)
  return linear(p, f'{name}.down_proj',
                F.silu(g) * linear(p, f'{name}.up_proj', x))


def route(p, name, x, cfg):
  """(weights (N, k), expert ids (N, k)): softmax over every expert, the
  top-k greedily, no renormalisation (`norm_topk_prob` false), times
  routed_scaling_factor."""
  scores = mm(x, p[f'{name}.gate.weight'].float().T).softmax(-1)
  w, idx = torch.topk(scores, cfg['num_experts_per_tok'], dim=-1,
                      sorted=False)
  return w * cfg['routed_scaling_factor'], idx


def moe(p, name, x, cfg, held=None, shared=True):
  """The MoE layer on rows x (N, H): the held experts lo..hi-1 (all by
  default; their weights stacked from lo) by a loop over experts, plus the
  shared experts where `shared`."""
  E = cfg['n_routed_experts']
  lo, hi = held or (0, E)
  w, idx = route(p, name, x, cfg)
  wg = p[f'{name}.experts.gate_proj'].float()
  wu = p[f'{name}.experts.up_proj'].float()
  wd = p[f'{name}.experts.down_proj'].float()
  out = torch.zeros_like(x)
  for e in range(lo, hi):
    tok, slot = (idx == e).nonzero(as_tuple=True)
    if not tok.numel():
      continue
    xe = x[tok]
    y = mm(F.silu(mm(xe, wg[e - lo].T)) * mm(xe, wu[e - lo].T),
           wd[e - lo].T)
    out.index_add_(0, tok, y * w[tok, slot, None])
  if shared and cfg['n_shared_experts']:
    out = out + swiglu(p, f'{name}.shared_experts', x)
  return out


def is_moe(cfg, i):
  return i >= cfg['first_k_dense_replace'] and i % cfg['moe_layer_freq'] == 0


def logits(p, z, action, cfg):
  """Token logits (B, T, z_size) of codes z (B, T, z_size) and actions
  (B, T, act_n): position t sees the codes and actions before t."""
  with no_tf32():
    B, T, _ = z.shape
    eps = cfg['rms_norm_eps']
    z, action = z.float(), action.float()
    x = linear(p, 'embed', z)
    x = torch.cat([x.new_zeros((B, 1, x.shape[-1])), x[:, :-1]], 1)
    a = torch.cat([action.new_zeros((B, 1, action.shape[-1])),
                   action[:, :-1]], 1)
    x = torch.cat([x, linear(p, 'cond_in', a)], -1)
    cos, sin = rope_tables(cfg, T, x.device)
    for i in range(cfg['num_hidden_layers']):
      n = f'layers.{i}'
      h = rms_norm(p, f'{n}.input_layernorm', x, eps)
      x = x + mla(p, f'{n}.self_attn', h, cfg, cos, sin)
      h = rms_norm(p, f'{n}.post_attention_layernorm', x, eps)
      if is_moe(cfg, i):
        x = x + moe(p, f'{n}.mlp', h.reshape(B * T, -1), cfg).reshape(
            B, T, -1)
      else:
        x = x + swiglu(p, f'{n}.mlp', h)
    return linear(p, 'dist_head.Dense_0', rms_norm(p, 'norm', x, eps))


def param_shapes(cfg, z_size, act_n):
  """{name: shape} of every weight, in the port module's order."""
  H, nh = cfg['hidden_size'], cfg['num_attention_heads']
  dn, dr, dv = cfg['qk_nope_head_dim'], cfg['qk_rope_head_dim'], \
      cfg['v_head_dim']
  r, E, Im = cfg['kv_lora_rank'], cfg['n_routed_experts'], \
      cfg['moe_intermediate_size']
  out = {'embed.weight': (H // 2, z_size), 'cond_in.weight': (H // 2, act_n)}
  for i in range(cfg['num_hidden_layers']):
    n = f'layers.{i}'
    out[f'{n}.input_layernorm.weight'] = (H,)
    a = f'{n}.self_attn'
    out[f'{a}.q_proj.weight'] = (nh * (dn + dr), H)
    out[f'{a}.kv_a_proj_with_mqa.weight'] = (r + dr, H)
    out[f'{a}.kv_a_layernorm.weight'] = (r,)
    out[f'{a}.kv_b_proj.weight'] = (nh * (dn + dv), r)
    out[f'{a}.o_proj.weight'] = (H, nh * dv)
    out[f'{n}.post_attention_layernorm.weight'] = (H,)
    m = f'{n}.mlp'
    if is_moe(cfg, i):
      out[f'{m}.gate.weight'] = (E, H)
      out[f'{m}.experts.gate_proj'] = (E, Im, H)
      out[f'{m}.experts.up_proj'] = (E, Im, H)
      out[f'{m}.experts.down_proj'] = (E, H, Im)
      if cfg['n_shared_experts']:
        Is = Im * cfg['n_shared_experts']
        out[f'{m}.shared_experts.gate_proj.weight'] = (Is, H)
        out[f'{m}.shared_experts.up_proj.weight'] = (Is, H)
        out[f'{m}.shared_experts.down_proj.weight'] = (H, Is)
    else:
      I = cfg['intermediate_size']
      out[f'{m}.gate_proj.weight'] = (I, H)
      out[f'{m}.up_proj.weight'] = (I, H)
      out[f'{m}.down_proj.weight'] = (H, I)
  out['norm.weight'] = (H,)
  out['dist_head.Dense_0.weight'] = (z_size, H)
  out['dist_head.Dense_0.bias'] = (z_size,)
  return out
