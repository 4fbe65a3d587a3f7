"""Shared conv encoder/decoder trunks of the VAE, the arbiters and the
object localizer (the port of research/nets/autoencoders/encoders.py).

NCHW inside, flax names outside. Two layouts differ from the JAX package's
NHWC and are undone here: `ConvTrunk` flattens its (C, H, W) feature map in
flax's (H, W, C) order before its Dense, so the Dense weight converts as
it is; `DeconvTrunk` returns (B, C, H, W), the JAX (B, H, W, C) permuted.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch.research.nets.common import (
    Conv, ConvTranspose, Dense, ResBlock)


def trunk_hw(lcd_h, lcd_w):
  """The feature map's (H, W) after ConvTrunk's three stride-2 'SAME'
  convolutions."""
  for _ in range(3):
    lcd_h, lcd_w = -(-lcd_h // 2), -(-lcd_w // 2)
  return lcd_h, lcd_w


class StateEmbed(nn.Module):
  def __init__(self, in_n, hidden_size):
    super().__init__()
    n = hidden_size
    self.Dense_0 = Dense(in_n, n)
    self.Dense_1 = Dense(n, n)
    self.Dense_2 = Dense(n, n)

  def forward(self, proprio):
    x = F.relu(self.Dense_1(F.relu(self.Dense_0(proprio))))
    return self.Dense_2(x)


class ConvTrunk(nn.Module):
  """3x stride-2 conv + ResBlock, proprio-conditioned; (B, C, H, W) ->
  flat feature (B, out_size)."""

  def __init__(self, hidden_size, nfilter, out_size, lcd_h, lcd_w,
               in_channels=1):
    super().__init__()
    nf = nfilter
    for i in range(3):
      setattr(self, f'Conv_{i}', Conv(in_channels if i == 0 else nf, nf, 3,
                                      stride=2))
      setattr(self, f'ResBlock_{i}', ResBlock(nf, hidden_size, group_size=4))
    h, w = trunk_hw(lcd_h, lcd_w)
    self.Dense_0 = Dense(h * w * nf, out_size)

  def forward(self, x, emb):
    for i in range(3):
      x = getattr(self, f'ResBlock_{i}')(getattr(self, f'Conv_{i}')(x), emb)
    # flax flattens NHWC: (H, W, C) order
    return self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class DeconvTrunk(nn.Module):
  """flat latent (B, z) -> (B, out_channels, H, W) logits, H = 16 via the
  ConvBinHead geometry (1x1 -> (4, 4 * ratio) -> x2 -> x2)."""

  def __init__(self, z_size, nfilter, wh_ratio, out_channels=1):
    super().__init__()
    nf = nfilter
    # VALID: 1x1 -> (4, 4 * ratio) (SAME would give 2x2)
    self.ConvTranspose_0 = ConvTranspose(z_size, nf, (4, int(wh_ratio * 4)),
                                         padding='VALID')
    self.ConvTranspose_1 = ConvTranspose(nf, nf, 4)
    self.Conv_0 = Conv(nf, nf, 3)
    self.ConvTranspose_2 = ConvTranspose(nf, out_channels, 4)

  def forward(self, z):
    x = F.relu(self.ConvTranspose_0(z.reshape(z.shape[0], -1, 1, 1)))
    x = F.relu(self.ConvTranspose_1(x))
    x = F.relu(self.Conv_0(x))
    return self.ConvTranspose_2(x)


class StateHead(nn.Module):
  def __init__(self, in_n, hidden_size, out_n):
    super().__init__()
    n = hidden_size
    self.Dense_0 = Dense(in_n, n)
    self.Dense_1 = Dense(n, n)
    self.Dense_2 = Dense(n, out_n)

  def forward(self, z):
    x = F.relu(self.Dense_1(F.relu(self.Dense_0(z))))
    return self.Dense_2(x)
