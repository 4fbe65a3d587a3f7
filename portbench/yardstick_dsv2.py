"""The frozen arithmetic of the DeepSeek-V2 world model's cell: its model
operations a dream step, counted from the shapes of the published model
(multiply-adds x 2), and the least time of one MoE layer's routed experts
on an H100, held fixed here so a change to the program cannot move them.
`s` is the cell's shapes (the driver's `shapes()`): the BVAE's and the
policy's as `portbench.yardstick` reads them, `cfg` the model's
config.json keys, `B` envs and `W` window positions."""
from __future__ import annotations

from portbench import yardstick

BF16_FLOPS = yardstick.BF16_FLOPS
HBM_BYTES_PER_S = yardstick.HBM_BYTES_PER_S


def _moe(cfg, i):
  return i >= cfg['first_k_dense_replace'] and i % cfg['moe_layer_freq'] == 0


def attn_macs(cfg):
  """Multiply-adds a token of one layer's MLA projections (queries
  uncompressed, `q_lora_rank` null)."""
  H, nh = cfg['hidden_size'], cfg['num_attention_heads']
  dn, dr, dv = cfg['qk_nope_head_dim'], cfg['qk_rope_head_dim'], \
      cfg['v_head_dim']
  r = cfg['kv_lora_rank']
  return H * nh * (dn + dr) + H * (r + dr) + r * nh * (dn + dv) + nh * dv * H


def routed_macs(cfg):
  """Multiply-adds a token of one MoE layer's routed experts (k of them)."""
  return cfg['num_experts_per_tok'] * 3 * cfg['hidden_size'] * \
      cfg['moe_intermediate_size']


def layer_macs(cfg, i):
  """Multiply-adds a token of layer i's projections, router and MLP or
  experts (shared and routed)."""
  H = cfg['hidden_size']
  if not _moe(cfg, i):
    return attn_macs(cfg) + 3 * H * cfg['intermediate_size']
  shared = 3 * H * cfg['moe_intermediate_size'] * cfg['n_shared_experts']
  return attn_macs(cfg) + H * cfg['n_routed_experts'] + shared + \
      routed_macs(cfg)


def matmul_flops(cfg, tokens):
  """The layers' matmuls over `tokens` tokens: 14.35 TFLOP at 3,200 tokens
  for DeepSeek-V2-Lite (2,241.6 M multiply-adds a token)."""
  return 2 * tokens * sum(layer_macs(cfg, i)
                          for i in range(cfg['num_hidden_layers']))


def transformer_flops(s):
  """One forward over the window for all B envs: the layers' matmuls, the
  full W x W attention scores and their product with the values in every
  layer, the code and action embeddings and the token head."""
  cfg, B, W = s['cfg'], s['B'], s['W']
  Z = s['zH'] * s['zW'] * s['vqD']
  H, nh = cfg['hidden_size'], cfg['num_attention_heads']
  att = nh * W * (cfg['qk_nope_head_dim'] + cfg['qk_rope_head_dim']
                  + cfg['v_head_dim'])
  ends = Z * H // 2 + s['A'] * H // 2 + H * Z
  return matmul_flops(cfg, B * W) + 2 * B * W * (
      cfg['num_hidden_layers'] * att + ends)


def dsv2_step_flops(s):
  """Model operations of one dream step of all B envs: the transformer
  over the window, and per env one frame through the BVAE's encoder (the
  frame the window gained; the others' codes are carried), one code grid
  decoded, the policy and the value."""
  return transformer_flops(s) + s['B'] * (
      yardstick.bvae_encode_flops(s) + yardstick.bvae_decode_flops(s)
      + yardstick.policy_flops(s))


def expert_weight_bytes(cfg, held=None):
  """Bytes of the routed experts' bfloat16 weights a layer holds (all
  experts unless `held`): 1.107 GB for DeepSeek-V2-Lite."""
  E = cfg['n_routed_experts'] if held is None else held
  return E * 3 * cfg['hidden_size'] * cfg['moe_intermediate_size'] * 2


def moe_expert_bound(cfg, slots, held=None):
  """Least seconds of one MoE layer's routed experts over `slots`
  token-expert pairs: the larger of their operations at 989 TFLOP/s and
  their bytes at 3.35 TB/s (the held experts' weights read once, the
  slots' bfloat16 input rows read once and output rows written once)."""
  H, I = cfg['hidden_size'], cfg['moe_intermediate_size']
  flops = 2 * slots * 3 * H * I
  nbytes = expert_weight_bytes(cfg, held) + 2 * slots * H * 2
  return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def moe_layers(cfg):
  return sum(_moe(cfg, i) for i in range(cfg['num_hidden_layers']))
