"""FBT (Flat Binary Token transformer), the headline world model (the port
of research/nets/video_models/fbt.py).

A GPT over frozen BVAE binary latents, action-conditioned, with a Bernoulli
token head. The frozen BVAE is loaded from G.weightdir; its parameters never
enter FBT's optimizer. Sampling and learned-env serving are KV-cached
(`FBTModule.step` + cached `sample`): the JAX scan bodies are Python loops
over positions here.
"""
from __future__ import annotations

import copy

import torch
import torch.nn as nn

from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.data.collect import pack_bits, unpack_bits
from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.common import (
    BinaryHead, Dense, LayerNorm, TransformerBlock)
from boxlcd_tpu_torch.research.nets.video_models._base import VideoModel

def pack_z(z):
  """(..., z_size) 0/1 codes -> (..., ceil(z_size / 8)) uint8, 8 codes a
  byte, MSB first (the JAX precompute_z's layout)."""
  pad = (-z.shape[-1]) % 8
  if pad:
    z = torch.cat([z, z.new_zeros((*z.shape[:-1], pad))], -1)
  return pack_bits(z)


class FBTModule(nn.Module):
  def __init__(self, n_embed, n_head, n_layer, block_size, z_size, act_n):
    super().__init__()
    self.n_embed, self.n_head, self.n_layer = n_embed, n_head, n_layer
    self.block_size = block_size
    self.embed = Dense(z_size, n_embed // 2, bias=False)
    self.cond_in = Dense(act_n, n_embed // 2, bias=False)
    # nonzero init required: shift-right makes the t=0 token all-zero, and a
    # zero vector through LayerNorm has a 1/sqrt(eps) backward blowup that
    # compounds per block to inf grads (clip then zeroes every update)
    self.pos_emb = nn.Parameter(torch.randn(1, block_size, n_embed) * 0.02)
    for i in range(n_layer):
      setattr(self, f'block{i}',
              TransformerBlock(n_embed, n_head, block_size))
    self.ln_f = LayerNorm(n_embed)
    self.make_head(n_embed, z_size)

  def make_head(self, n_embed, z_size):
    self.dist_head = BinaryHead(n_embed, z_size)

  def head(self, x):
    """The final features -> token logits."""
    return self.dist_head(x).logits

  def blocks(self):
    return [getattr(self, f'block{i}') for i in range(self.n_layer)]

  def forward(self, z, action):
    """z (B, T, z_size), action (B, T, act_n) -> token logits (B, T, z_size).

    Shift-right conditioning: position t sees z[<t], action[<t]
    (reference: flat_btoken.py:52-67).
    """
    B, T, _ = z.shape
    x = self.embed(z)
    x = torch.cat([x.new_zeros((B, 1, x.shape[-1])), x[:, :-1]], 1)
    a = torch.cat([action.new_zeros((B, 1, action.shape[-1])),
                   action[:, :-1]], 1)
    x = torch.cat([x, self.cond_in(a)], -1)
    x = x + self.pos_emb[:, :T]
    for block in self.blocks():
      x = block(x)
    return self.head(self.ln_f(x))

  def empty_cache(self, B):
    """Per layer a preallocated (k, v) pair, each (B, H, S, hs), in the
    module's dtype and device."""
    p = self.pos_emb
    hs = self.n_embed // self.n_head
    kv = lambda: p.new_zeros((B, self.n_head, self.block_size, hs))
    return tuple((kv(), kv()) for _ in range(self.n_layer))

  def step(self, z_prev, a_prev, i, caches):
    """KV-cached single-position forward: logits (B, z_size) for position i
    given the previous token (z_prev, a_prev), each (B, feat); the caches
    get position i's keys and values."""
    x = torch.cat([self.embed(z_prev[:, None]),
                   self.cond_in(a_prev[:, None])], -1)
    x = x + self.pos_emb[:, i:i + 1]
    for block, cache in zip(self.blocks(), caches):
      x, _ = block(x, cache=cache, index=i)
    return self.head(self.ln_f(x))[:, 0], caches


class FBT(VideoModel):
  def __init__(self, env, G, bvae=None):
    super().__init__(env, G)
    if bvae is None:
      from boxlcd_tpu_torch.research.nets._base import Net
      from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
      bvae = BVAE(env, Net.load_config(G.weightdir, 'BVAE'))
      bvae.load(G.weightdir, resume=False)
      print('LOADED BVAE', G.weightdir)
    self.bvae = bvae  # frozen: its params never enter the optimizer
    self.bvae.module.requires_grad_(False)
    self.z_size = bvae.z_size
    self._init()
    self._net64 = None   # (weights' key, float64 copy) for `sample`
    self._graphs = {}    # (device, shapes) -> a CUDA graph of the encode

  def build(self):
    G = self.G
    return FBTModule(G.n_embed, G.n_head, G.n_layer, self.block_size,
                     self.z_size, self.act_n)

  def _latents(self, batch):
    if 'z' in batch:  # precomputed frozen-BVAE latents (fast path)
      z = batch['z']
      if z.shape[-1] != self.z_size:  # bit-packed storage: 8 codes/byte
        z = unpack_bits(z.to(torch.uint8), self.z_size)
      return z.float()
    with torch.no_grad():
      return self.bvae.encode(batch, noise=False)

  def loss_fn(self, batch, gen=None):
    z = self._latents(batch)
    logits = self.module(z, batch['action']).float()
    loss = -dists.Bernoulli(logits).log_prob(z).mean()
    return loss, {'loss/total': loss}

  @torch.no_grad()
  def precompute_z(self, data, chunk=None, unpack=None):
    """Encode the whole device-resident dataset through the frozen BVAE once,
    as bit-packed codes (uint8, 8 a byte), so training samples latents
    instead of re-encoding bs*window frames per step. `unpack` maps stored
    lcd to full frames (DeviceDataset.unpack_lcd for bit-packed storage)."""
    unpack = unpack or (lambda x: x)
    if chunk is None:
      # bound the conv activations by PIXEL count, not episode count: ~1e7
      # px a chunk keeps the float32 activations (~px * nfilter * 4 B a
      # layer) near 1.5 GB whatever the episode length and frame size
      px_per_ep = 8  # lcd is bit-packed uint8: 8 px/byte
      for d in data['lcd'].shape[1:]:
        px_per_ep *= int(d)
      chunk = max(1, int(1e7) // max(px_per_ep, 1))
    outs = []
    for i in range(0, data['lcd'].shape[0], chunk):
      lcd = unpack(data['lcd'][i:i + chunk]).float()
      # threshold, don't cast: straight-through z values sit within ~1e-7
      # of 0/1, and a cast truncates 0.9999999 to 0
      z = self.bvae.encode({'lcd': lcd,
                            'proprio': data['proprio'][i:i + chunk]}) > 0.5
      outs.append(pack_z(z))
    return torch.cat(outs)

  # -- serving -------------------------------------------------------------------
  cached_sample = True   # `sample(use_cache=True)` serves through `step`

  def serving(self):
    """(the transformer `sample` runs, the dtype of its codes and actions):
    the float64 copy (`serving_net`)."""
    return self.serving_net(), torch.float64

  def serving_net(self):
    """The float64 copy of the transformer that `sample` runs: made once
    and kept until a parameter changes. An optimizer step and a load write
    the parameters in place, which bumps their version counters; a move to
    another device changes their storage."""
    key = tuple((p.data_ptr(), p._version) for p in self.module.parameters())
    if self._net64 is None or self._net64[0] != key:
      self._net64 = (key, copy.deepcopy(self.module).double())
    return self._net64[1]

  @torch.no_grad()
  def latent_onestep(self, z, a, i, gen, temp=1.0):
    """Sample token i given tokens < i (reference: flat_btoken.py:87-91)."""
    logits = self.module(z, a)
    z = z.clone()
    z[:, i] = dists.Bernoulli(logits[:, i] / temp).sample(gen)
    return z

  @torch.no_grad()
  def encode_window(self, batch):
    """The window's codes (B, W, z_size): the BVAE over every frame, as
    `onestep` encodes a window that carries none. A caller that steps the
    window puts them in the window batch under 'z' and slides them with
    the frames."""
    z = self.bvae.encode(batch, noise=False)
    trace.count('onestep.frames_encoded', z.shape[0] * z.shape[1])
    return z

  def _replay(self, where, key, fn, inputs):
    """fn(*inputs) on the card as the replay of a CUDA graph of fn at these
    shapes: one launch where the host would enqueue fn's kernels one by
    one. The graph is captured at the first call for `where` (after three
    warm-up calls on a side stream) and again once `key` changes; the
    result is its output buffer, valid until the next replay."""
    with torch.cuda.device(inputs[0].device):
      g = self._graphs.get(where)
      if g is None or g[0] != key:
        ins = tuple(x.clone(memory_format=torch.contiguous_format)
                    for x in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm-up: workspaces, plans
          for _ in range(3):
            fn(*ins)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
          out = fn(*ins)
        g = self._graphs[where] = (key, graph, ins, out)
      _, graph, ins, out = g
      for dst, src in zip(ins, inputs):
        dst.copy_(src)
      graph.replay()
    return out

  def _encode_frames(self, lcd, proprio):
    """The BVAE's codes (B, z_size) of B frames, lcd (B, H, W) and proprio
    (B, p). On the card, the replay of a CUDA graph of the encode at these
    shapes (`_replay`): one launch where the host would enqueue the
    encode's hundred kernels, each step; captured again once a BVAE
    parameter changes (as `serving_net` keys its copy)."""
    if lcd.device.type != 'cuda':
      return self.bvae.encode({'lcd': lcd, 'proprio': proprio}, noise=False)
    key = tuple((p.data_ptr(), p._version)
                for p in self.bvae.module.parameters())
    return self._replay(
        (lcd.device, lcd.shape, proprio.shape), key,
        lambda f, p: self.bvae.encode({'lcd': f, 'proprio': p}, noise=False),
        (lcd, proprio))

  def transformer(self, z, action):
    """The transformer's token logits (B, T, z_size) for `onestep`."""
    return self.module(z, action)

  @torch.no_grad()
  def onestep(self, batch, i, gen, temp=1.0, u=None):
    """Learned-env serving: predict frame i from the window
    (reference: flat_btoken.py:77-85). The token draws read uniforms u
    (B, z_size), drawn from `gen` unless given. Spans (trace):
    `onestep.encode` (the BVAE over the window), `onestep.fbt`,
    `onestep.draw`, `onestep.decode` (the BVAE decode and the writes).

    A window batch that carries its codes under 'z' (`encode_window`),
    valid at positions < i - 1, has only frame i - 1 encoded, the frame
    the window gained since the last step; the returned batch carries the
    codes, then valid at positions < i. The BVAE encodes each frame on its
    own and the FBT is causal, so the logits at i are the full path's.
    The counters `onestep.frames_encoded` and `onestep.codes_reused` count
    the frames put through the encoder and the codes taken as carried."""
    with trace.span('onestep.encode'):
      if 'z' in batch:
        z = batch['z'].clone()
        z[:, i - 1] = self._encode_frames(batch['lcd'][:, i - 1],
                                          batch['proprio'][:, i - 1])
        B, W = z.shape[:2]
        trace.count('onestep.frames_encoded', B)
        trace.count('onestep.codes_reused', B * (W - 1))
      else:
        z = self.encode_window(batch)
    with trace.span('onestep.fbt'):
      logits = self.transformer(z, batch['action'])
    with trace.span('onestep.draw'):
      zi = dists.Bernoulli(logits[:, i] / temp).sample(gen, u=u)
    with trace.span('onestep.decode'):
      dec = self.bvae.decode(self.bvae.unflatten_z(zi))
      batch = dict(batch)
      batch['lcd'] = batch['lcd'].clone()
      batch['proprio'] = batch['proprio'].clone()
      batch['lcd'][:, i] = (dec['lcd'].probs > 0.5).float()
      batch['proprio'][:, i] = dec['proprio'].mean
      if 'z' in batch:
        batch['z'] = z
    return batch

  @torch.no_grad()
  def sample(self, gen, n, action=None, prompts=None, prompt_n=10, temp=1.0,
             use_cache=True, u=None):
    """AR rollout in latent space, then one batch decode
    (reference: flat_btoken.py:98-125).

    use_cache=True serves each position through the KV-cached `step`;
    False runs the reference's full forward per position. Both read the
    same uniforms u (T, n, z_size), drawn from `gen` after the actions
    unless given, and the transformer runs in float64 (`serving_net`) for
    both: the two paths' probabilities then agree to ~1e-15, so the same
    uniforms give the same bits (in float32 they differ by ~1e-6, which
    flips about one Bernoulli draw in a million). Training and `onestep`
    run in float32: a float32 sampler would need its equality check
    restated (the same draws wherever |p - u| exceeds a stated margin)."""
    T = self.block_size
    if action is None:
      action = torch.rand((n, T, self.act_n), generator=gen,
                          device=self.device) * 2 - 1
    n = action.shape[0]
    if u is None:
      u = torch.rand((T, n, self.z_size), generator=gen, device=self.device)
    H, W = self.env.lcd_h, self.env.lcd_w
    lcd = torch.zeros((n, T, H, W), device=self.device)
    proprio = torch.zeros((n, T, self.proprio_n), device=self.device)
    start = 0
    if prompts is not None:
      lcd[:, :prompt_n] = prompts['lcd'][:, :prompt_n]
      proprio[:, :prompt_n] = prompts['proprio'][:, :prompt_n]
      start = prompt_n
    z = self.bvae.encode({'lcd': lcd, 'proprio': proprio}, noise=False)
    z[:, start:] = 0.0
    net, dtype = self.serving()
    z = z.to(dtype)
    act = action.to(dtype)
    if use_cache and self.cached_sample:
      caches = net.empty_cache(n)
      zero_z, zero_a = z.new_zeros((n, self.z_size)), act.new_zeros(
          (n, self.act_n))
      for i in range(T):
        # prompt positions only write their cache rows
        z_prev = z[:, i - 1] if i > 0 else zero_z
        a_prev = act[:, i - 1] if i > 0 else zero_a
        logits, caches = net.step(z_prev, a_prev, i, caches)
        if i >= start:
          z[:, i] = dists.Bernoulli(logits / temp).sample(u=u[i])
    else:
      for i in range(start, T):
        logits = net(z, act)[:, i]
        z[:, i] = dists.Bernoulli(logits / temp).sample(u=u[i])
    dec = self.bvae.decode(self.bvae.unflatten_z(z.reshape(n * T, -1).float()))
    lcd = (dec['lcd'].probs > 0.5).float()
    return {'lcd': lcd.reshape(n, T, *lcd.shape[1:]),
            'proprio': dec['proprio'].mean.reshape(n, T, -1)}
