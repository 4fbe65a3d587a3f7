"""The port's convolution-transpose layer, encoder trunks and conv heads
against the JAX package's, from the same (flax-initialised) parameters
carried over by boxlcd_tpu_torch.research.nets.convert, on numpy-seeded
inputs.

Covered: flax's `nn.ConvTranspose` at every shape DeconvTrunk and
ConvBinHead give it (the VALID 1x1 -> (4, 4 * wh_ratio) expansion at
wh_ratio 1, 1.5 and 2, the SAME x2 steps, 1 and more output channels),
its refusal of kernels flax pads unevenly; the padding rule against
`jax.lax`'s; StateEmbed, ConvTrunk (its NHWC flatten order, 1 and window
input channels, 16x16, 16x24 and 16x32 frames), DeconvTrunk, StateHead,
ConvEmbed, ConvBinHead and MultiHead; and `convert`'s name-keyed kernel
rule. Tolerance: 1e-5 absolute (float32).
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from jax._src.lax.convolution import _conv_transpose_padding

from boxlcd_tpu_torch.research.nets import common
from boxlcd_tpu_torch.research.nets.autoencoders import encoders
from boxlcd_tpu_torch.research.nets.convert import (
    flax_to_state_dict, load_flax)
from research.nets import common as jcommon
from research.nets.autoencoders import encoders as jencoders

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

TOL = 1e-5
FRAMES = [(16, 16, 1.0), (16, 24, 1.5), (16, 32, 2.0)]   # H, W, wh_ratio


def _close(ours, ref, tol=TOL):
  ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
  ref = np.asarray(ref)
  assert ours.shape == ref.shape, (ours.shape, ref.shape)
  err = np.abs(ours.astype(np.float64) - ref.astype(np.float64)).max()
  assert err <= tol, err


def _init(module, *args):
  params = module.init(jax.random.PRNGKey(0), *args)
  return jax.tree_util.tree_map(np.asarray, params)


def _normal(shape, seed=0):
  return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
  return torch.as_tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize('padding', ['SAME', 'VALID'])
def test_conv_transpose_padding_is_jax_lax_rule(padding):
  for k in range(1, 9):
    for s in range(1, 4):
      assert common.conv_transpose_padding(k, s, padding) == \
          _conv_transpose_padding(k, s, padding), (k, s)


# (in_ch, out_ch, kernel, padding, input H x W): DeconvTrunk's and
# ConvBinHead's shapes, then one where flax's rule takes its other branch
CT_SHAPES = [
    (8, 16, (4, 4), 'VALID', (1, 1)),      # wh_ratio 1
    (8, 16, (4, 6), 'VALID', (1, 1)),      # wh_ratio 1.5
    (8, 16, (4, 8), 'VALID', (1, 1)),      # wh_ratio 2
    (16, 16, (4, 4), 'SAME', (4, 8)),
    (16, 16, (4, 4), 'SAME', (8, 16)),
    (16, 1, (4, 4), 'SAME', (8, 12)),      # one output channel
    (16, 5, (4, 4), 'SAME', (8, 16)),      # frames as channels
    (6, 4, (2, 2), 'SAME', (5, 3)),        # s > k - 1: pads (1, 1)
]


@pytest.mark.parametrize('cin,cout,k,padding,hw', CT_SHAPES)
def test_conv_transpose_matches_flax(cin, cout, k, padding, hw):
  x = _normal((3, *hw, cin), seed=sum(k) + cin)
  ref = fnn.ConvTranspose(cout, k, strides=(2, 2), padding=padding)
  params = _init(ref, x)
  holder = torch.nn.Module()   # the flax name the convert rule keys on
  holder.ConvTranspose_0 = common.ConvTranspose(cin, cout, k, padding=padding)
  load_flax(holder, {'ConvTranspose_0': params['params']})
  with torch.no_grad():
    y = holder.ConvTranspose_0(_nchw(x))
  _close(y.permute(0, 2, 3, 1), ref.apply(params, x))


@pytest.mark.parametrize('k,padding', [((3, 3), 'SAME'), ((1, 3), 'VALID')])
def test_conv_transpose_refuses_uneven_padding(k, padding):
  """flax pads (2, 1) and (0, 1) here; no model uses such a kernel."""
  with pytest.raises(ValueError, match='unevenly'):
    common.ConvTranspose(6, 4, k, padding=padding)


def test_convert_keys_the_transpose_rule_on_the_name():
  k = _normal((4, 6, 3, 5))                     # HWIO
  sd = flax_to_state_dict({'Conv_0': {'kernel': k},
                           'ConvTranspose_0': {'kernel': k}})
  assert np.array_equal(sd['Conv_0.weight'].numpy(), k.transpose(3, 2, 0, 1))
  assert np.array_equal(sd['ConvTranspose_0.weight'].numpy(),
                        k[::-1, ::-1].transpose(2, 3, 0, 1))


def test_state_embed_and_head():
  p = _normal((5, 7))
  for jm, tm in ((jencoders.StateEmbed(16), encoders.StateEmbed(7, 16)),
                 (jencoders.StateHead(16, 3), encoders.StateHead(7, 16, 3))):
    params = _init(jm, p)
    load_flax(tm, params)
    with torch.no_grad():
      _close(tm(torch.as_tensor(p)), jm.apply(params, p))


@pytest.mark.parametrize('h,w,ratio', FRAMES)
@pytest.mark.parametrize('cin', [1, 5])
def test_conv_trunk_flatten_order(h, w, ratio, cin):
  """flax flattens the (H, W, C) map; the port permutes before its
  reshape, so the converted Dense weight reads the same features."""
  x = _normal((3, h, w, cin), seed=cin)
  emb = _normal((3, 16), seed=1)
  jm = jencoders.ConvTrunk(16, 8, 24, in_channels=cin)
  params = _init(jm, x, emb)
  # random GroupNorm scales/biases and a non-zero ResBlock output conv, so
  # every parameter reaches the output
  params = jax.tree_util.tree_map(
      lambda a: a + 0.1 * _normal(a.shape, seed=a.size), params)
  tm = load_flax(encoders.ConvTrunk(16, 8, 24, h, w, in_channels=cin),
                 params)
  assert encoders.trunk_hw(h, w) == (2, -(-w // 8))
  with torch.no_grad():
    _close(tm(_nchw(x), torch.as_tensor(emb)), jm.apply(params, x, emb))
  # the same weights without the permute read other features
  with torch.no_grad():
    feat = tm.ResBlock_2(tm.Conv_2(tm.ResBlock_1(tm.Conv_1(tm.ResBlock_0(
        tm.Conv_0(_nchw(x)), torch.as_tensor(emb))), torch.as_tensor(emb))),
        torch.as_tensor(emb))
    wrong = tm.Dense_0(feat.reshape(3, -1))
  assert np.abs(wrong.numpy() - np.asarray(jm.apply(params, x, emb))).max() \
      > 1e-3


@pytest.mark.parametrize('h,w,ratio', FRAMES)
@pytest.mark.parametrize('cout', [1, 5])
def test_deconv_trunk(h, w, ratio, cout):
  z = _normal((3, 12))
  jm = jencoders.DeconvTrunk(8, ratio, out_channels=cout)
  params = _init(jm, z)
  tm = load_flax(encoders.DeconvTrunk(12, 8, ratio, out_channels=cout),
                 params)
  with torch.no_grad():
    y = tm(torch.as_tensor(z))
  assert y.shape == (3, cout, h, w)
  _close(y.permute(0, 2, 3, 1), jm.apply(params, z))


def test_conv_embed():
  x = (_normal((2, 3, 16 * 24)) > 0).astype(np.float32)
  jm = jcommon.ConvEmbed(16, 24)
  params = _init(jm, x)
  tm = load_flax(common.ConvEmbed(16, 24), params)
  with torch.no_grad():
    _close(tm(torch.as_tensor(x)), jm.apply(params, x))


@pytest.mark.parametrize('ratio', [1.0, 1.5, 2.0])
def test_conv_bin_head(ratio):
  x = _normal((2, 3, 12))
  jm = jcommon.ConvBinHead(int(256 * ratio), ratio)
  params = _init(jm, x)
  tm = load_flax(common.ConvBinHead(12, ratio), params)
  with torch.no_grad():
    logits = tm(torch.as_tensor(x)).logits
  assert logits.shape == (2, 3, int(256 * ratio))
  _close(logits, jm.apply(params, x).logits)


@pytest.mark.parametrize('conv_io', [0, 1])
def test_multi_head(conv_io):
  x = _normal((2, 3, 20))
  split = 256 if conv_io else 10
  jm = jcommon.MultiHead(12, split + 4, split, conv_io=conv_io)
  params = _init(jm, x)
  tm = load_flax(common.MultiHead(20, 12, split + 4, split, conv_io=conv_io),
                 params)
  target = _normal((2, 3, 4), seed=3)
  with torch.no_grad():
    out = tm(torch.as_tensor(x))
  ref = jm.apply(params, x)
  _close(out['lcd'].logits, ref['lcd'].logits)
  _close(out['proprio'].log_prob(torch.as_tensor(target)),
         ref['proprio'].log_prob(target))
  _close(out['proprio'].mean, ref['proprio'].mean)
