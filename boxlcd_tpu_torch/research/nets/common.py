"""Shared NN blocks (the port of research/nets/common.py).

The same computational contracts as the flax blocks: shapes, distribution
heads, conditioning. Submodule attribute names are the flax parameter-tree
names (`Dense_0`, `Conv_1`, `ln1`, ...), so `convert.py` maps a flax tree
onto these modules by name alone. Layers are initialised as flax
initialises them (lecun-normal kernels, zero biases) and the norms use
flax's eps = 1e-6.

Convolutions run NCHW inside; `Conv` pads as flax's 'SAME' does, which
for a stride-2 convolution on an even size pads (0 before, 1 after), not
torch's symmetric `padding=1`; `ConvTranspose` is flax's transposed
convolution (its kernel flipped, its padding `jax.lax.conv_transpose`'s).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch.research.nets import dists

NORM_EPS = 1e-6          # flax LayerNorm / GroupNorm


def lecun_normal_(weight, fan_in):
  """flax's default kernel init: a normal of variance 1/fan_in truncated at
  two standard deviations (variance_scaling, 'truncated_normal')."""
  std = math.sqrt(1.0 / fan_in) / .87962566103423978
  with torch.no_grad():
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def Dense(in_n, out_n, bias=True, zero=False):
  """flax nn.Dense as nn.Linear (weight (out, in) = the flax kernel's
  transpose)."""
  layer = nn.Linear(in_n, out_n, bias=bias)
  if zero:
    nn.init.zeros_(layer.weight)
  else:
    lecun_normal_(layer.weight, in_n)
  if bias:
    nn.init.zeros_(layer.bias)
  return layer


def same_pad(size, k, s):
  """flax/XLA 'SAME' padding of one spatial axis: (before, after)."""
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


class Conv(nn.Conv2d):
  """flax nn.Conv(padding='SAME') on NCHW tensors (weight OIHW = the flax
  HWIO kernel transposed)."""

  def __init__(self, in_ch, out_ch, k, stride=1, zero=False):
    super().__init__(in_ch, out_ch, k, stride, padding=0)
    if zero:
      nn.init.zeros_(self.weight)
    else:
      lecun_normal_(self.weight, in_ch * k * k)
    nn.init.zeros_(self.bias)

  def forward(self, x):
    k, s = self.kernel_size[0], self.stride[0]
    ph = same_pad(x.shape[-2], k, s)
    pw = same_pad(x.shape[-1], k, s)
    if ph[0] == ph[1] and pw[0] == pw[1]:
      return F.conv2d(x, self.weight, self.bias, s, (ph[0], pw[0]))
    return F.conv2d(F.pad(x, (*pw, *ph)), self.weight, self.bias, s)


def conv_transpose_padding(k, s, padding):
  """jax.lax.conv_transpose's (before, after) padding of one spatial axis:
  the input is dilated by the stride, padded so, and cross-correlated with
  the (unflipped) kernel."""
  if padding == 'SAME':
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
  elif padding == 'VALID':
    pad_len = k + s - 2 + max(k - s, 0)
    pad_a = k - 1
  else:
    raise ValueError(f'padding {padding!r}')
  return pad_a, pad_len - pad_a


class ConvTranspose(nn.ConvTranspose2d):
  """flax nn.ConvTranspose (transpose_kernel=False) on NCHW tensors.

  flax cross-correlates the stride-dilated, padded input with its HWIO
  kernel; torch's transposed convolution correlates with the kernel
  flipped. So the weight (in, out, kh, kw) is the flax kernel flipped in
  both spatial axes (`convert.py` keys that rule on the `ConvTranspose_<i>`
  name), and the padding is flax's, `conv_transpose_padding` per axis, as
  torch's k - 1 - p on both sides. Every kernel the models use (4, 6, 8 at
  stride 2, 'SAME' and 'VALID') pads both sides alike; another raises."""

  def __init__(self, in_ch, out_ch, k, stride=2, padding='SAME'):
    ks = (k, k) if isinstance(k, int) else tuple(k)
    pads = [conv_transpose_padding(kk, stride, padding) for kk in ks]
    if any(a != b for a, b in pads):
      raise ValueError(f'flax pads kernel {ks} at stride {stride} '
                       f'{padding!r} unevenly: {pads}')
    super().__init__(in_ch, out_ch, ks, stride,
                     padding=tuple(kk - 1 - a for (a, _), kk in zip(pads, ks)))
    # flax's lecun-normal over the kernel's fan in (kh * kw * in)
    lecun_normal_(self.weight, in_ch * ks[0] * ks[1])
    nn.init.zeros_(self.bias)


def LayerNorm(n):
  return nn.LayerNorm(n, eps=NORM_EPS)


class CausalSelfAttention(nn.Module):
  """Masked multi-head self-attention (reference: common.py:22-57), written
  out as the JAX einsums are: scores, a -inf mask, a float32 softmax."""

  def __init__(self, n_embed, n_head, block_size):
    super().__init__()
    self.n_embed, self.n_head, self.block_size = n_embed, n_head, block_size
    self.qkv = Dense(n_embed, 3 * n_embed)
    self.proj = Dense(n_embed, n_embed)

  def forward(self, x, cache=None, index=None):
    """Full causal attention over x (B, T, E). With `cache=(k, v)`, each
    (B, H, S, hs) and preallocated, and a position `index`, x is a single
    token (B, 1, E): its k/v are written into the cache at `index` (in
    place) and attention runs against the cached prefix. Returns the output,
    and with a cache also the cache."""
    B, T, E = x.shape
    H = self.n_head
    hs = E // H
    q, k, v = (t.reshape(B, T, H, hs).transpose(1, 2)
               for t in self.qkv(x).split(E, -1))
    if cache is None:
      keys, vals = k, v
      mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    else:
      keys, vals = cache
      keys[:, :, index] = k[:, :, 0].to(keys.dtype)
      vals[:, :, index] = v[:, :, 0].to(vals.dtype)
      mask = (torch.arange(keys.shape[2], device=x.device) <= index)[None]
    att = (q @ keys.transpose(-1, -2)).float() / math.sqrt(hs)
    att = att.masked_fill(~mask, float('-inf')).softmax(-1)
    y = att.to(vals.dtype) @ vals
    y = self.proj(y.transpose(1, 2).reshape(B, T, E))
    return y if cache is None else (y, cache)


class GRUCell(nn.Module):
  """flax nn.GRUCell (JAX: video_models/rssm.py:39) as one torch.gru_cell:
  r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
  n = tanh(in(x) + r * hn(h)), h' = (1 - z) n + z h, which is
  torch.nn.GRUCell's formula. flax's recurrent kernels hr and hz carry no
  bias, so the parameters are flax's: `weight_ih` the input kernels
  [ir; iz; in] (3F, in), `weight_hh` [hr; hz; hn] (3F, F), `bias_ih`
  their biases, and `bias_hn` hn's alone; the cell's recurrent bias is
  [0; 0; bias_hn]. `convert.py` stacks a flax cell's six kernels so. Init
  as flax's: lecun-normal input kernels, orthogonal recurrent ones per
  gate, zero biases."""

  def __init__(self, in_n, features):
    super().__init__()
    F_ = features
    self.weight_ih = nn.Parameter(torch.empty(3 * F_, in_n))
    self.weight_hh = nn.Parameter(torch.empty(3 * F_, F_))
    self.bias_ih = nn.Parameter(torch.zeros(3 * F_))
    self.bias_hn = nn.Parameter(torch.zeros(F_))
    for g in range(3):
      lecun_normal_(self.weight_ih[g * F_:(g + 1) * F_], in_n)
      with torch.no_grad():
        nn.init.orthogonal_(self.weight_hh[g * F_:(g + 1) * F_])

  def forward(self, h, x):
    """(carry h (B, F), input x (B, in)) -> the new carry (B, F)."""
    b_hh = torch.cat([self.bias_hn.new_zeros(2 * self.bias_hn.shape[0]),
                      self.bias_hn])
    return torch.gru_cell(x, h, self.weight_ih, self.weight_hh,
                          self.bias_ih, b_hh)


class TransformerBlock(nn.Module):
  """Pre-LN transformer block (reference: common.py:59-74)."""

  def __init__(self, n_embed, n_head, block_size):
    super().__init__()
    self.ln1 = LayerNorm(n_embed)
    self.attn = CausalSelfAttention(n_embed, n_head, block_size)
    self.ln2 = LayerNorm(n_embed)
    self.Dense_0 = Dense(n_embed, 4 * n_embed)
    self.Dense_1 = Dense(4 * n_embed, n_embed)

  def forward(self, x, cache=None, index=None):
    if cache is None:
      x = x + self.attn(self.ln1(x))
    else:
      a, cache = self.attn(self.ln1(x), cache, index)
      x = x + a
    h = F.gelu(self.Dense_0(self.ln2(x)), approximate='tanh')  # flax nn.gelu
    out = x + self.Dense_1(h)
    return out if cache is None else (out, cache)


class GaussHead(nn.Module):
  """Diagonal-Gaussian head (reference: common.py:76-91)."""

  def __init__(self, in_n, z_size, min_std=1e-4):
    super().__init__()
    self.min_std = min_std
    self.Dense_0 = Dense(in_n, 2 * z_size)

  def forward(self, x, past_z=None):
    mu, log_std = self.Dense_0(x).chunk(2, -1)
    std = F.softplus(log_std) + self.min_std
    if past_z is not None:
      mu = mu + past_z
    return dists.Normal(mu, std)


class MDNHead(nn.Module):
  """Mixture-density head (reference: common.py:93-112)."""

  def __init__(self, in_n, out_n, mdn_k=5, min_std=1e-4):
    super().__init__()
    self.out_n, self.mdn_k, self.min_std = out_n, mdn_k, min_std
    self.Dense_0 = Dense(in_n, mdn_k + 2 * mdn_k * out_n)

  def forward(self, x):
    out = self.Dense_0(x)
    dx = self.mdn_k * self.out_n
    shape = (*out.shape[:-1], self.mdn_k, self.out_n)
    mu = out[..., :dx].reshape(shape)
    std = F.softplus(out[..., dx:2 * dx]).reshape(shape) + self.min_std
    return dists.MixtureOfGaussians(out[..., 2 * dx:], mu, std)


class CategoricalHead(nn.Module):
  def __init__(self, in_n, out_n):
    super().__init__()
    self.Dense_0 = Dense(in_n, out_n)

  def forward(self, x):
    return dists.Categorical(self.Dense_0(x))


class BinaryHead(nn.Module):
  """Bernoulli head (reference: common.py:123-130)."""

  def __init__(self, in_n, out_n):
    super().__init__()
    self.Dense_0 = Dense(in_n, out_n)

  def forward(self, x):
    return dists.Bernoulli(self.Dense_0(x))


class ConvEmbed(nn.Module):
  """Frame -> flat embedding via a small conv stack (reference:
  common.py:156-170): x (BS, LEN, lcd_h * lcd_w) -> (BS, LEN, lcd_h *
  lcd_w). One output channel, so NCHW and NHWC flatten alike."""

  def __init__(self, lcd_h, lcd_w):
    super().__init__()
    self.lcd_h, self.lcd_w = lcd_h, lcd_w
    self.Conv_0 = Conv(1, 64, 3)
    self.Conv_1 = Conv(64, 1, 3)

  def forward(self, x):
    BS, LEN, _ = x.shape
    h = x.reshape(BS * LEN, 1, self.lcd_h, self.lcd_w)
    h = self.Conv_1(F.relu(self.Conv_0(h)))
    return h.reshape(BS, LEN, -1)


class ConvBinHead(nn.Module):
  """Latent -> frame logits via a deconv stack (reference:
  common.py:132-154): x (BS, LEN, in_n) -> Bernoulli over (BS, LEN,
  16 * 16 * wh_ratio) frames, 1x1 -> (4, 4 * wh_ratio) -> x2 -> x2."""

  def __init__(self, in_n, wh_ratio):
    super().__init__()
    self.ConvTranspose_0 = ConvTranspose(in_n, 64, (4, int(wh_ratio * 4)),
                                         padding='VALID')
    self.ConvTranspose_1 = ConvTranspose(64, 64, 4)
    self.ConvTranspose_2 = ConvTranspose(64, 1, 4)

  def forward(self, x):
    BS, LEN, E = x.shape
    h = F.relu(self.ConvTranspose_0(x.reshape(BS * LEN, E, 1, 1)))
    h = F.relu(self.ConvTranspose_1(h))
    h = self.ConvTranspose_2(h)
    return dists.Bernoulli(h.reshape(BS, LEN, -1))


class MultiHead(nn.Module):
  """Joint lcd (Bernoulli) + proprio (MDN) head (reference:
  common.py:185-206). x (..., x_n) -> {'lcd': Bernoulli over `split`
  outputs, 'proprio': MDN over out_n - split}."""

  def __init__(self, x_n, in_n, out_n, split, mdn_k=5, min_std=1e-4,
               conv_io=0, wh_ratio=1.0):
    super().__init__()
    self.conv_io = conv_io
    self.Dense_0 = Dense(x_n, 2 * in_n)
    if conv_io:
      self.ConvBinHead_0 = ConvBinHead(in_n, wh_ratio)
    else:
      self.BinaryHead_0 = BinaryHead(in_n, split)
    self.MDNHead_0 = MDNHead(in_n, out_n - split, mdn_k, min_std)

  def forward(self, x):
    xb, xs = self.Dense_0(x).chunk(2, -1)
    head = self.ConvBinHead_0 if self.conv_io else self.BinaryHead_0
    return {'lcd': head(xb), 'proprio': self.MDNHead_0(xs)}


class ResBlock(nn.Module):
  """GroupNorm+SiLU residual conv block with embedding conditioning
  (reference: common.py:208-238); the final conv starts at zero. NCHW."""

  def __init__(self, channels, emb_channels, out_channels=None,
               group_size=16):
    super().__init__()
    out_ch = out_channels or channels
    self.GroupNorm_0 = nn.GroupNorm(group_size, channels, eps=NORM_EPS)
    self.Conv_0 = Conv(channels, out_ch, 3)
    self.Dense_0 = Dense(emb_channels, out_ch)
    self.GroupNorm_1 = nn.GroupNorm(group_size, out_ch, eps=NORM_EPS)
    self.Conv_1 = Conv(out_ch, out_ch, 3, zero=True)
    if out_ch != channels:
      self.Conv_2 = Conv(channels, out_ch, 1)

  def forward(self, x, emb):
    h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
    h = h + self.Dense_0(F.silu(emb))[:, :, None, None]
    h = self.Conv_1(F.silu(self.GroupNorm_1(h)))
    skip = self.Conv_2(x) if hasattr(self, 'Conv_2') else x
    return skip + h


class Upsample(nn.Module):
  """Nearest-x2 upsample + conv (reference: bvae.py:95-103). NCHW."""

  def __init__(self, in_ch, out_ch):
    super().__init__()
    self.Conv_0 = Conv(in_ch, out_ch, 3)

  def forward(self, x):
    x = x.repeat_interleave(2, -2).repeat_interleave(2, -1)
    return self.Conv_0(x)


def aggregate(x, dim=1):
  """min/max/std/mean aggregation (reference: common.py:241-254); std is the
  population std, as jnp.std."""
  return torch.cat([x.amin(dim), x.amax(dim), x.std(dim, correction=0),
                    x.mean(dim)], -1)


def zero_params(module):
  """Zero every parameter of `module` in place (reference: common.py:16-20
  zero_module) and return it."""
  with torch.no_grad():
    for p in module.parameters():
      p.zero_()
  return module
