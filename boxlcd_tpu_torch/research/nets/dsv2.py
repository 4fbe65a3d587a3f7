"""DeepSeek-V2 blocks: RMSNorm, YaRN rotary positions, multi-head latent
attention (MLA), the SwiGLU MLP and the mixture-of-experts layer, at the
widths of a DeepSeek-V2 `config.json` (`LITE`: DeepSeek-V2-Lite,
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json),
and `DSV2Module`, a DeepSeek-V2 decoder behind the FBT's interface
(`forward(z, action)`, `blocks()`, `head`) for `FBTDSV2`.

The equations are the published model's (`modeling_deepseek.py`). Per
layer, with x the residual (B, T, hidden):
  h = RMSNorm(x); q = W_q h, heads of qk_nope + qk_rope;
  [c_kv | k_pe] = W_kva h; c_kv = RMSNorm(c_kv); [k_nope | v] = W_kvb c_kv;
  rotary positions on q_pe and k_pe (k_pe one for all heads), in the
  published interleaved-pair layout with YaRN's blended frequencies;
  causal softmax attention over [k_nope | k_pe] at the scale
  (qk_nope + qk_rope)^-0.5 * m^2, m = 0.1 * mscale_all_dim * ln(factor) + 1;
  x += W_o(attn); h = RMSNorm(x);
  the first `first_k_dense_replace` layers:
    x += W_down(silu(W_gate h) * W_up h);
  the others: s = softmax(W_g h) in float32, the top-k by s greedily, no
  renormalisation (`norm_topk_prob` false), scaled by
  `routed_scaling_factor`; x += shared(h) + sum_k s_k E_k(h).
After the last layer: a final RMSNorm.

Precision as published: weights and matmul inputs in the module's dtype
(bfloat16 on the card, float32 accumulation); the router's logits and
softmax, the norms' statistics and the head's logits in float32; the
attention scores' softmax in float32, rounded to the dtype before the
product with the values; each routed expert's output rounded to the dtype
before the float32 weighted sum, which is rounded again before the shared
experts' output is added.

Departures from the published model, all at its two ends or where one
rounding takes the place of several (fewer launches a layer):
- a norm scales in float32 and rounds once (the published one rounds the
  normalised row, then its product with the scale); the rotary positions
  turn each pair in float32 and round once, and keep the pairs interleaved
  (the published model de-interleaves both q and k alike, which leaves the
  scores unchanged); the output projections of attention and of the
  dense MLP add the residual in their epilogue and round once; the
  attention's scores are scaled and masked in the product's float32
  epilogue and rounded once before the float32 softmax;
- the vocabulary (102,400 rows) and the LM head are replaced by the FBT's
  input side and head: the codes of the BVAE (`z_size` binary codes a
  frame) shifted right, `embed(z)` concatenated with `cond_in(action)`
  (hidden / 2 each), and a Bernoulli head (`dist_head.Dense_0`) over the
  codes; there is no learned position embedding (positions are rotary);
- on the card the routed experts run in the grouped-expert kernels
  (`moe_kernel.py`), which keep gate and up in float32 and round
  silu(gate) * up once, where the published model rounds gate, up, the
  activation and the product each to bfloat16;
- only the Lite model's choices are built (`config` raises on others):
  softmax scores, greedy top-k, no renormalisation, no query compression
  (`q_lora_rank` null); the full DeepSeek-V2's group-limited routing and
  compressed queries are not.

The MoE layer may be built holding a range of the experts (`held`, all of
them by default): it keeps those experts' weights, routes over every
expert and adds what its own experts give, as one shard of expert
parallelism computes (a route to another shard's expert weighs 0 there);
the shared experts are every shard's.

Spans (boxlcd_tpu_torch.trace): `dsv2.attn` around each layer's attention
(norm, MLA, residual add), `dsv2.moe` around each MoE layer's (norm,
router, experts, residual add), `dsv2.mlp` around the dense layers'. Each
MoE layer keeps its last token counts on the device (`MoE.counts`);
`DSV2Module.count_moe` adds them, while tracing, to the counters
`moe.tokens_routed` (token-expert pairs), `moe.tokens_busiest` (the
busiest expert's tokens) and `moe.rows_tiled` (the token rows the expert
kernels' tiles cover, padding included: `moe_kernel.rows_tiled`; routed
over tiled is the tiling share), summed over layers and calls and read at
trace.stop(): the eager forward calls it, `FBTDSV2` after each replay of
its graph.
"""
from __future__ import annotations

import json
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.research.nets import moe_kernel

# DeepSeek-V2-Lite's config.json, the keys that shape the model
LITE = {
    'hidden_size': 2048, 'intermediate_size': 10944,
    'moe_intermediate_size': 1408, 'n_routed_experts': 64,
    'n_shared_experts': 2, 'num_experts_per_tok': 6,
    'first_k_dense_replace': 1, 'moe_layer_freq': 1,
    'num_hidden_layers': 27, 'num_attention_heads': 16,
    'q_lora_rank': None, 'kv_lora_rank': 512, 'qk_nope_head_dim': 128,
    'qk_rope_head_dim': 64, 'v_head_dim': 128, 'rms_norm_eps': 1e-6,
    'rope_theta': 10000,
    'rope_scaling': {'beta_fast': 32, 'beta_slow': 1, 'factor': 40,
                     'mscale': 0.707, 'mscale_all_dim': 0.707,
                     'original_max_position_embeddings': 4096,
                     'type': 'yarn'},
    'norm_topk_prob': False, 'routed_scaling_factor': 1.0,
    'scoring_func': 'softmax', 'topk_method': 'greedy',
}


def config(over=None):
  """LITE with `over` laid over it: a dict, a JSON string, or ''/None."""
  if isinstance(over, str):
    over = json.loads(over) if over.strip() else {}
  cfg = dict(LITE, **(over or {}))
  built = {'scoring_func': 'softmax', 'topk_method': 'greedy',
           'norm_topk_prob': False, 'q_lora_rank': None}
  other = {k: cfg[k] for k, v in built.items() if cfg[k] != v}
  if other:
    raise NotImplementedError(f'{other}: only DeepSeek-V2-Lite\'s {built} '
                              'is built')
  return cfg


def is_moe_layer(cfg, i):
  return i >= cfg['first_k_dense_replace'] and i % cfg['moe_layer_freq'] == 0


# -- rotary positions ---------------------------------------------------------

def yarn_mscale(scale, mscale):
  return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg):
  """The dims (low, high) of YaRN's ramp between the extrapolated and the
  interpolated frequencies, over rope dims / 2 frequencies."""
  rs, dim, base = cfg['rope_scaling'], cfg['qk_rope_head_dim'], \
      cfg['rope_theta']
  orig = rs['original_max_position_embeddings']

  def dim_of(rot):
    return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))
  low = math.floor(dim_of(rs['beta_fast']))
  high = math.ceil(dim_of(rs['beta_slow']))
  return max(low, 0), min(high, dim - 1)


def rope_tables(cfg, T, device=None):
  """(cos, sin), each (T, qk_rope_head_dim) float32, of positions 0..T-1:
  YaRN's inverse frequencies (extrapolated below the ramp, divided by
  `factor` above it, blended linearly across it), each repeated for the
  two halves; the cos/sin scale mscale / mscale_all_dim."""
  dim, base = cfg['qk_rope_head_dim'], cfg['rope_theta']
  rs = cfg.get('rope_scaling')
  exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
  extra = 1.0 / (base ** exps)
  scale = 1.0
  if rs:
    factor = rs['factor']
    inter = 1.0 / (factor * base ** exps)
    low, high = yarn_correction_range(cfg)
    if low == high:
      high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    inv = inter * (1 - keep) + extra * keep
    scale = yarn_mscale(factor, rs['mscale']) / yarn_mscale(
        factor, rs['mscale_all_dim'])
  else:
    inv = extra
  t = torch.arange(T, dtype=torch.float32, device=device)
  emb = torch.outer(t, inv)
  emb = torch.cat([emb, emb], -1)
  return emb.cos() * scale, emb.sin() * scale


def softmax_scale(cfg):
  """(qk_nope + qk_rope)^-0.5, times mscale_all_dim's m squared under
  YaRN."""
  s = (cfg['qk_nope_head_dim'] + cfg['qk_rope_head_dim']) ** -0.5
  rs = cfg.get('rope_scaling')
  if rs:
    m = yarn_mscale(rs['factor'], rs['mscale_all_dim'])
    s = s * m * m
  return s


def rope_cis(cfg, T, device=None):
  """The rotations of positions 0..T-1 as complex numbers (T, rope / 2):
  pair j of a position turns by its angle and scales by the tables'
  mscale ratio (`rope_tables`' cos and sin of the first half)."""
  cos, sin = rope_tables(cfg, T, device)
  d = cos.shape[-1] // 2
  return torch.complex(cos[:, :d], sin[:, :d])


def rotate(x, cis):
  """x (B, T, ..., d) rotated in the published interleaved pairs (x0, x1),
  (x2, x3), ... by cis (T, d / 2), in float32, rounded once to x's dtype.
  The pairs stay interleaved where the published model de-interleaves
  them (evens, then odds) before the same rotation: applied alike to q and
  k, the order of the rotary dims leaves every score unchanged."""
  T = x.shape[1]
  c = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
  c = c * cis.view(T, *([1] * (x.dim() - 3)), -1)
  return torch.view_as_real(c).flatten(-2).to(x.dtype)


def attend(q, kv, k_pe, cis, bias, scale):
  """MLA's core: q (B, T, nh, dn + dr) before rotation, kv (B, T, nh, dn +
  dv), k_pe (B, T, dr) before rotation, cis (T, dr / 2), bias (T, T) the
  causal mask (0 on and below the diagonal, -inf above) -> (B, T, nh *
  dv)."""
  B, T, nh, dq = q.shape
  dr = k_pe.shape[-1]
  dn, dv = dq - dr, kv.shape[-1] - (dq - dr)
  q = torch.cat([q[..., :dn], rotate(q[..., dn:], cis)], -1)
  k = torch.cat([kv[..., :dn],
                 rotate(k_pe, cis)[:, :, None].expand(B, T, nh, dr)], -1)
  q = q.transpose(1, 2).reshape(B * nh, T, dq)
  k = k.transpose(1, 2).reshape(B * nh, T, dq)
  # scaled and masked in the product's epilogue, rounded once; the softmax
  # of the rounded scores runs in float32 and rounds once
  att = torch.baddbmm(bias, q, k.transpose(1, 2), alpha=scale).softmax(-1)
  v = kv[..., dn:].transpose(1, 2).reshape(B * nh, T, dv)
  y = torch.bmm(att, v).view(B, nh, T, dv).transpose(1, 2)
  return y.reshape(B, T, nh * dv)


# -- blocks -------------------------------------------------------------------

def _linear(n_in, n_out, bias=False):
  """nn.Linear in the ambient device and dtype, N(0, 1/n_in) weights."""
  layer = nn.Linear(n_in, n_out, bias=bias)
  with torch.no_grad():
    layer.weight.normal_(0.0, n_in ** -0.5)
    if bias:
      layer.bias.zero_()
  return layer


class RMSNorm(nn.Module):
  def __init__(self, n, eps):
    super().__init__()
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(n))

  def forward(self, x):
    return F.rms_norm(x, self.weight.shape, self.weight, self.eps)


class MLA(nn.Module):
  """Multi-head latent attention (causal, over the whole window)."""

  def __init__(self, cfg):
    super().__init__()
    H, nh = cfg['hidden_size'], cfg['num_attention_heads']
    self.nh = nh
    self.dn, self.dr = cfg['qk_nope_head_dim'], cfg['qk_rope_head_dim']
    self.dv, self.rank = cfg['v_head_dim'], cfg['kv_lora_rank']
    self.q_proj = _linear(H, nh * (self.dn + self.dr))
    self.kv_a_proj_with_mqa = _linear(H, self.rank + self.dr)
    self.kv_a_layernorm = RMSNorm(self.rank, cfg['rms_norm_eps'])
    self.kv_b_proj = _linear(self.rank, nh * (self.dn + self.dv))
    self.o_proj = _linear(nh * self.dv, H)
    self.scale = softmax_scale(cfg)

  def forward(self, h, cis, bias, residual):
    """residual + the attention's output, for h (B, T, H) the normed
    residual; cis the rotations of the T positions; bias (T, T) the causal
    mask, 0 on and below the diagonal, -inf above."""
    B, T, _ = h.shape
    q = self.q_proj(h).view(B, T, self.nh, self.dn + self.dr)
    c_kv, k_pe = self.kv_a_proj_with_mqa(h).split([self.rank, self.dr], -1)
    kv = self.kv_b_proj(self.kv_a_layernorm(c_kv))
    kv = kv.view(B, T, self.nh, self.dn + self.dv)
    return _add_linear(residual, attend(q, kv, k_pe, cis, bias, self.scale),
                       self.o_proj)


def _add_linear(residual, x, layer):
  """residual + layer(x) (a bias-free Linear) as one product whose epilogue
  adds the residual and rounds once."""
  H = layer.weight.shape[0]
  return torch.addmm(residual.reshape(-1, H), x.reshape(-1, x.shape[-1]),
                     layer.weight.t()).view(residual.shape)


class SwiGLU(nn.Module):
  def __init__(self, H, inter):
    super().__init__()
    self.gate_proj = _linear(H, inter)
    self.up_proj = _linear(H, inter)
    self.down_proj = _linear(inter, H)

  def forward(self, x, residual=None):
    """down(silu(gate x) * up x), added to `residual` where one is given
    (`_add_linear`)."""
    a = F.silu(self.gate_proj(x)) * self.up_proj(x)
    if residual is None:
      return self.down_proj(a)
    return _add_linear(residual, a, self.down_proj)


class Experts(nn.Module):
  """The routed experts a layer holds, stacked: gate_proj and up_proj
  (E, inter, H), down_proj (E, H, inter), N(0, 1/fan_in)."""

  def __init__(self, E, H, inter):
    super().__init__()
    self.gate_proj = nn.Parameter(torch.randn(E, inter, H) * H ** -0.5)
    self.up_proj = nn.Parameter(torch.randn(E, inter, H) * H ** -0.5)
    self.down_proj = nn.Parameter(torch.randn(E, H, inter) * inter ** -0.5)

  def one(self, e, x):
    """Expert e (of those held) on rows x, in x's dtype."""
    g = x @ self.gate_proj[e].T
    u = x @ self.up_proj[e].T
    return (F.silu(g) * u) @ self.down_proj[e].T


class MoE(nn.Module):
  """Softmax router over every routed expert, greedy top-k, the experts in
  `held` = (lo, hi) (all by default), the shared experts."""

  def __init__(self, cfg, held=None):
    super().__init__()
    H, E = cfg['hidden_size'], cfg['n_routed_experts']
    inter = cfg['moe_intermediate_size']
    self.E, self.k = E, cfg['num_experts_per_tok']
    self.held = (0, E) if held is None else tuple(held)
    if not 0 <= self.held[0] < self.held[1] <= E:
      raise ValueError(f'held experts {self.held} outside 0..{E}')
    self.scaling = float(cfg['routed_scaling_factor'])
    self.gate = nn.Module()
    self.gate.weight = nn.Parameter(torch.randn(E, H) * H ** -0.5)
    n = self.held[1] - self.held[0]
    self.experts = Experts(n, H, inter)
    if cfg['n_shared_experts']:
      self.shared_experts = SwiGLU(H, inter * cfg['n_shared_experts'])
    # the held experts' token counts of the last call, on the device
    self.register_buffer('counts', torch.zeros(n, dtype=torch.int32),
                         persistent=False)

  def route(self, x):
    """(weights (N, k) float32, expert ids (N, k) int64 among the held
    experts) of rows x (N, H): the router's softmax in float32, its greedy
    top-k (`held_routes`). On the card the logits are one product of the
    bfloat16 rows and weights with a float32 result, the same sums as the
    float32 product of the two cast."""
    if x.is_cuda and x.dtype == torch.bfloat16:
      logits = torch.mm(x, self.gate.weight.t(), out_dtype=torch.float32)
    else:
      logits = F.linear(x.float(), self.gate.weight.float())
    scores = logits.softmax(-1)
    w, idx = torch.topk(scores, self.k, dim=-1, sorted=False)
    return self.held_routes(w if self.scaling == 1.0 else w * self.scaling,
                            idx)

  def held_routes(self, w, idx):
    """Routes (weights, ids among all experts) as this layer's: ids counted
    from its first expert; a route to an expert it does not hold weighs 0
    (and goes to its nearest held expert)."""
    lo, hi = self.held
    if (lo, hi) == (0, self.E):
      return w, idx
    mine = (idx >= lo) & (idx < hi)
    return torch.where(mine, w, 0.0), (idx - lo).clamp(0, hi - lo - 1)

  def routed_plain(self, x, w, idx):
    """The experts' weighted sum (N, H) in x's dtype for the held routes
    (`route`), by a loop over experts: each expert's output rounded to the
    dtype, summed in float32. Synchronises with the host (the rows each
    expert takes)."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(self.counts.shape[0]):
      tok, slot = (idx == e).nonzero(as_tuple=True)
      self.counts[e] = tok.numel()
      if not tok.numel():
        continue
      y = self.experts.one(e, x[tok])
      out.index_add_(0, tok, y.float() * w[tok, slot, None])
    return out.to(x.dtype)

  def forward(self, h, residual=None):
    """The layer's output for h (..., H), added to `residual` where one is
    given (in the combine kernel on the card)."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    w, idx = self.route(x)
    shared = self.shared_experts(x) if hasattr(self, 'shared_experts') \
        else None
    if x.device.type == 'cuda' and not torch.is_grad_enabled():
      e = self.experts
      res = None if residual is None else residual.reshape(x.shape)
      out, _ = moe_kernel.moe_experts(
          x, w, idx, e.gate_proj, e.up_proj, e.down_proj, shared, res,
          self.counts)
      return out.view(shape)
    y = self.routed_plain(x, w, idx)
    if shared is not None:
      y = y + shared
    if residual is not None:
      y = residual.reshape(x.shape) + y
    return y.view(shape)


class DSV2Block(nn.Module):
  def __init__(self, cfg, i, held=None):
    super().__init__()
    eps = cfg['rms_norm_eps']
    self.input_layernorm = RMSNorm(cfg['hidden_size'], eps)
    self.self_attn = MLA(cfg)
    self.post_attention_layernorm = RMSNorm(cfg['hidden_size'], eps)
    self.moe = is_moe_layer(cfg, i)
    self.mlp = MoE(cfg, held) if self.moe else \
        SwiGLU(cfg['hidden_size'], cfg['intermediate_size'])

  def forward(self, x, cis, bias):
    with trace.span('dsv2.attn'):
      x = self.self_attn(self.input_layernorm(x), cis, bias, x)
    with trace.span('dsv2.moe' if self.moe else 'dsv2.mlp'):
      return self.mlp(self.post_attention_layernorm(x), residual=x)


class DSV2Module(nn.Module):
  """A DeepSeek-V2 decoder as the FBT's transformer: codes (B, T, z_size)
  and actions (B, T, act_n), shifted right, to token logits (B, T, z_size)
  in float32. Parameters are made in the ambient device and default dtype
  (`torch.device(...)` context, `torch.set_default_dtype`) or moved after;
  the rotations are a complex64 buffer, the causal mask one in the
  default dtype."""

  def __init__(self, cfg, block_size, z_size, act_n, held=None):
    super().__init__()
    H = cfg['hidden_size']
    self.cfg, self.block_size = cfg, block_size
    self.n_layer = cfg['num_hidden_layers']
    self.embed = _linear(z_size, H // 2)
    self.cond_in = _linear(act_n, H // 2)
    self.layers = nn.ModuleList(DSV2Block(cfg, i, held)
                                for i in range(self.n_layer))
    self.norm = RMSNorm(H, cfg['rms_norm_eps'])
    self.dist_head = nn.Module()
    self.dist_head.Dense_0 = _linear(H, z_size, bias=True)
    self.register_buffer('rope_cis', rope_cis(cfg, block_size),
                         persistent=False)
    self.register_buffer('causal_bias', torch.full(
        (block_size, block_size), float('-inf')).triu(1), persistent=False)

  def head(self, x):
    """The final features -> token logits, in float32."""
    d = self.dist_head.Dense_0
    return F.linear(x.float(), d.weight.float(), d.bias.float())

  def blocks(self):
    return list(self.layers)

  def count_moe(self):
    """While tracing, add the MoE layers' last token counts to the
    counters `moe.tokens_routed`, `moe.tokens_busiest` and
    `moe.rows_tiled`, on the device (a few launches, no
    synchronisation)."""
    buf = trace.world_counts(('moe.tokens_routed', 'moe.tokens_busiest',
                              'moe.rows_tiled'), 1, self.causal_bias.device)
    counts = [b.mlp.counts for b in self.layers if b.moe]
    if buf is None or not counts:
      return
    c = torch.stack(counts)
    buf[0].add_(torch.stack([c.sum(), c.amax(1).sum(),
                             moe_kernel.rows_tiled(c).sum()]).to(buf.dtype))

  def forward(self, z, action):
    B, T, _ = z.shape
    dt = self.embed.weight.dtype
    x = self.embed(z.to(dt))
    x = torch.cat([x.new_zeros((B, 1, x.shape[-1])), x[:, :-1]], 1)
    a = action.to(dt)
    a = torch.cat([a.new_zeros((B, 1, a.shape[-1])), a[:, :-1]], 1)
    x = torch.cat([x, self.cond_in(a)], -1)
    cis, bias = self.rope_cis[:T], self.causal_bias[:T, :T]
    for layer in self.layers:
      x = layer(x, cis, bias)
    if trace.ON and not (x.is_cuda and
                         torch.cuda.is_current_stream_capturing()):
      self.count_moe()
    return self.head(self.norm(x))
