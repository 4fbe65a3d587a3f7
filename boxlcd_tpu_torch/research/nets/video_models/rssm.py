"""RSSM: Dreamer-v1-style latent dynamics (the port of
research/nets/video_models/rssm.py): a GRU deterministic state (256) and a
Gaussian stochastic one (64), a KL with free nats, and the conv trunks of
the autoencoders for encoder and decoder.

The JAX package scans its recurrences with `lax.scan`; here `observe` and
`imagine` are Python loops over time. Their Gaussian noise comes from a
`torch.Generator` unless it is handed in (`eps`, (T, B, STOCH) a draw), so
a test can feed both packages the same normals.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from boxlcd_tpu_torch import parallel
from boxlcd_tpu_torch.research.nets import dists
from boxlcd_tpu_torch.research.nets.autoencoders.encoders import (
    ConvTrunk, DeconvTrunk, StateEmbed, StateHead)
from boxlcd_tpu_torch.research.nets.common import Dense, GRUCell
from boxlcd_tpu_torch.research.nets.video_models._base import VideoModel

STOCH, DETER, EMBED = 64, 256, 256
FIELDS = ('mean', 'std', 'stoch', 'deter')


def initial(batch_size, device):
  return {'mean': torch.zeros((batch_size, STOCH), device=device),
          'std': torch.zeros((batch_size, STOCH), device=device),
          'stoch': torch.zeros((batch_size, STOCH), device=device),
          'deter': torch.zeros((batch_size, DETER), device=device)}


def _normal(gen, like, eps):
  if eps is None:
    eps = parallel.randn(like.shape, gen, like.device)
  return eps


def _stack(states):
  """A list over time of state dicts -> one dict of (B, T, ...)."""
  return {k: torch.stack([s[k] for s in states], 1) for k in FIELDS}


class RSSMModule(nn.Module):
  def __init__(self, hidden_size, nfilter, proprio_n, act_n, wh_ratio, lcd_h,
               lcd_w):
    super().__init__()
    n = hidden_size
    self.state_embed = StateEmbed(proprio_n, n)
    self.trunk = ConvTrunk(n, nfilter, EMBED, lcd_h, lcd_w)
    self.cell = GRUCell(n, DETER)
    self.deconv = DeconvTrunk(STOCH + DETER, nfilter, wh_ratio)
    self.state_head = StateHead(STOCH + DETER, n, proprio_n)
    self.obs1 = Dense(DETER + EMBED, n)
    self.obs2 = Dense(n, 2 * STOCH)
    self.img1 = Dense(STOCH + act_n, n)
    self.img2 = Dense(DETER, n)
    self.img3 = Dense(n, 2 * STOCH)

  def encode(self, lcd, proprio):
    """lcd (B, H, W), proprio (B, p) -> embedding (B, EMBED)."""
    return self.trunk(lcd[:, None], self.state_embed(proprio))

  def decode(self, feat):
    state = self.state_head(feat)
    return {'lcd': dists.Bernoulli(self.deconv(feat)[:, 0]),
            'proprio': dists.Normal(state, torch.ones_like(state))}

  def img_step(self, prev, action, gen=None, eps=None):
    """Prior: advance the recurrent state with the action (JAX:
    rssm.py:58-68)."""
    x = F.relu(self.img1(torch.cat([prev['stoch'], action], -1)))
    deter = self.cell(prev['deter'], x)
    mean, std = self.img3(F.relu(self.img2(deter))).chunk(2, -1)
    std = F.softplus(std) + 0.1
    stoch = mean + std * _normal(gen, mean, eps)
    return {'mean': mean, 'std': std, 'stoch': stoch, 'deter': deter}

  def obs_step(self, prev, action, embed, gen=None, eps=(None, None)):
    """Posterior given the frame embedding (JAX: rssm.py:70-80); eps
    is (the prior's normals, the posterior's)."""
    prior = self.img_step(prev, action, gen, eps[0])
    h = F.relu(self.obs1(torch.cat([prior['deter'], embed], -1)))
    mean, std = self.obs2(h).chunk(2, -1)
    std = F.softplus(std) + 0.1
    stoch = mean + std * _normal(gen, mean, eps[1])
    post = {'mean': mean, 'std': std, 'stoch': stoch, 'deter': prior['deter']}
    return post, prior


class RSSM(VideoModel):
  def __init__(self, env, G):
    super().__init__(env, G)
    self._init()

  def build(self):
    G = self.G
    return RSSMModule(G.hidden_size, G.nfilter, self.proprio_n, self.act_n,
                      G.wh_ratio, self.env.lcd_h, self.env.lcd_w)

  # -- recurrences (Python loops over time) ------------------------------------
  def observe(self, embed, action, gen=None, state=None, eps=None):
    """embed/action (B, T, ...) -> (posts, priors), each (B, T, ...); eps
    (prior normals, posterior normals), each (T, B, STOCH), drawn from
    `gen` step by step unless given."""
    B, T = action.shape[:2]
    state = initial(B, action.device) if state is None else state
    posts, priors = [], []
    for t in range(T):
      e = (None, None) if eps is None else (eps[0][t], eps[1][t])
      state, prior = self.module.obs_step(state, action[:, t], embed[:, t],
                                          gen, e)
      posts.append(state)
      priors.append(prior)
    return _stack(posts), _stack(priors)

  def imagine(self, action, gen=None, state=None, eps=None):
    """action (B, T, act) -> priors (B, T, ...); eps (T, B, STOCH)."""
    B, T = action.shape[:2]
    state = initial(B, action.device) if state is None else state
    priors = []
    for t in range(T):
      state = self.module.img_step(state, action[:, t], gen,
                                   None if eps is None else eps[t])
      priors.append(state)
    return _stack(priors)

  def _embed(self, lcd, proprio):
    B, T = lcd.shape[:2]
    return self.module.encode(lcd.reshape(B * T, *lcd.shape[2:]),
                              proprio.reshape(B * T, -1)).reshape(B, T, -1)

  def loss_fn(self, batch, gen=None, eps=None):
    """Recon + free-nats KL (JAX: rssm.py:138-162); eps as
    `observe` takes it, for the T - 1 transitions."""
    lcd, proprio, action = batch['lcd'], batch['proprio'], batch['action']
    B, T = action.shape[:2]
    embed = self._embed(lcd, proprio)
    posts, priors = self.observe(embed[:, 1:], action[:, :-1], gen, eps=eps)
    feat = torch.cat([posts['stoch'], posts['deter']], -1)
    dec = self.module.decode(feat.reshape(B * (T - 1), -1))
    tgt_lcd = lcd[:, 1:].reshape(B * (T - 1), *lcd.shape[2:])
    tgt_pro = proprio[:, 1:].reshape(B * (T - 1), -1)
    recon_lcd = -dec['lcd'].log_prob(tgt_lcd).mean()
    recon_proprio = -dec['proprio'].log_prob(tgt_pro).mean() / self.proprio_n
    recon = recon_lcd + recon_proprio
    post_d = dists.Normal(posts['mean'], posts['std'], independent=False)
    prior_d = dists.Normal(priors['mean'], priors['std'], independent=False)
    kl = post_d.kl(prior_d)
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    div = torch.maximum(kl, torch.full_like(kl, self.G.free_nats)).mean()
    div_loss = self.G.kl_scale * div
    loss = recon + div_loss
    return loss, {'loss/total': loss, 'div_loss': div_loss,
                  'loss/recon_total': recon, 'loss/recon_lcd': recon_lcd,
                  'loss/recon_proprio': recon_proprio}

  def _decode_seq(self, feat, n, T):
    dec = self.module.decode(feat.reshape(n * T, -1))
    lcd = (dec['lcd'].probs > 0.5).float()
    return {'lcd': lcd.reshape(n, T, *lcd.shape[1:]),
            'proprio': dec['proprio'].mean.reshape(n, T, -1)}

  @torch.no_grad()
  def sample(self, gen, n, action=None, prompts=None, prompt_n=10, temp=1.0,
             eps=None):
    """Observe the prompt, then imagine (JAX: rssm.py:171-200). The
    prompt is observed with the actions shifted right by one. eps, when
    given, is {'observe': (prior, posterior) normals (prompt_n, n, STOCH),
    'imagine': (T - prompt_n, n, STOCH)} ({'imagine': (T, n, STOCH)}
    without prompts); otherwise the normals come from `gen` after the
    actions."""
    T = self.block_size
    eps = eps or {}
    if action is None:
      action = torch.rand((n, T, self.act_n), generator=gen,
                          device=self.device) * 2 - 1
    n = action.shape[0]
    if prompts is None:
      priors = self.imagine(action, gen, eps=eps.get('imagine'))
      feat = torch.cat([priors['stoch'], priors['deter']], -1)
      return self._decode_seq(feat, n, T)
    p_lcd = prompts['lcd'][:, :prompt_n].float()
    p_pro = prompts['proprio'][:, :prompt_n].float()
    embed = self._embed(p_lcd, p_pro)
    a_shift = torch.cat([torch.zeros_like(action[:, :1]), action[:, :-1]], 1)
    posts, _ = self.observe(embed, a_shift[:, :prompt_n], gen,
                            eps=eps.get('observe'))
    last = {k: v[:, -1] for k, v in posts.items()}
    priors = self.imagine(a_shift[:, prompt_n:], gen, last,
                          eps=eps.get('imagine'))
    feat = torch.cat([priors['stoch'], priors['deter']], -1)
    gen_ = self._decode_seq(feat, n, T - prompt_n)
    return {'lcd': torch.cat([p_lcd, gen_['lcd']], 1),
            'proprio': torch.cat([p_pro, gen_['proprio']], 1)}

  def onestep(self, batch, i, gen, temp=1.0, u=None):
    raise NotImplementedError('learned-env serving uses FBT/FRNLD')
