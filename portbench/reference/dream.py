"""The plain reference of the learned env's step and the policy, written out
from the published layer equations (boxLCD's research/nets: the BVAE of
bvae.py, the FBT of flat_btoken.py over common.py's blocks, the PPO actor
and critic of pponets.py) as plain torch functions of a dict of weights by
parameter name. Nothing here imports the program; the names are the
parameter names the benchmark drew the weights under.

Conventions of the published nets that the equations carry: flax 'SAME'
padding (a stride-2 convolution on an even size pads 0 before, 1 after),
norms with eps 1e-6, GroupNorm over 4 groups in the BVAE's residual blocks,
the tanh form of gelu, a Bernoulli latent taken as its mode (sigmoid >
0.5) at encode time, shift-right conditioning in the FBT.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6
GROUPS = 4


def dense(p, name, x):
  y = x @ p[f'{name}.weight'].T
  b = p.get(f'{name}.bias')
  return y if b is None else y + b


def _same(size, k, s):
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


def conv(p, name, x, stride=1):
  """flax nn.Conv(padding='SAME') on NCHW."""
  w = p[f'{name}.weight']
  k = w.shape[-1]
  ph, pw = _same(x.shape[-2], k, stride), _same(x.shape[-1], k, stride)
  x = F.pad(x, (*pw, *ph))
  return F.conv2d(x, w, p[f'{name}.bias'], stride)


def group_norm(p, name, x):
  return F.group_norm(x, GROUPS, p[f'{name}.weight'], p[f'{name}.bias'], EPS)


def layer_norm(p, name, x):
  return F.layer_norm(x, x.shape[-1:], p[f'{name}.weight'],
                      p[f'{name}.bias'], EPS)


def resblock(p, name, x, emb):
  h = conv(p, f'{name}.Conv_0', F.silu(group_norm(p, f'{name}.GroupNorm_0', x)))
  h = h + dense(p, f'{name}.Dense_0', F.silu(emb))[:, :, None, None]
  h = conv(p, f'{name}.Conv_1', F.silu(group_norm(p, f'{name}.GroupNorm_1', h)))
  skip = conv(p, f'{name}.Conv_2', x) if f'{name}.Conv_2.weight' in p else x
  return skip + h


def encode(p, lcd, proprio):
  """BVAE encoder: frames (N, H, W) and proprio (N, P) -> binary codes
  (N, zH * zW * vqD) in (zH, zW, vqD) order."""
  e = 'encoder'
  emb = F.relu(dense(p, f'{e}.Dense_1', F.relu(dense(p, f'{e}.Dense_0',
                                                      proprio))))
  emb = dense(p, f'{e}.Dense_2', emb)
  x = conv(p, f'{e}.Conv_0', lcd[:, None])
  x = resblock(p, f'{e}.ResBlock_0', x, emb)
  x = resblock(p, f'{e}.ResBlock_1', conv(p, f'{e}.Conv_1', x, 2), emb)
  x = resblock(p, f'{e}.ResBlock_2', conv(p, f'{e}.Conv_2', x, 2), emb)
  logits = conv(p, f'{e}.Conv_3', x).permute(0, 2, 3, 1)
  return (torch.sigmoid(logits) > 0.5).to(lcd.dtype).reshape(lcd.shape[0], -1)


def upsample(p, name, x):
  x = x.repeat_interleave(2, -2).repeat_interleave(2, -1)
  return conv(p, f'{name}.Conv_0', x)


def decode(p, z, zH, zW, vqD):
  """BVAE decoder: codes (N, zH * zW * vqD) -> (frame logits (N, H, W),
  proprio mean (N, P))."""
  d = 'decoder'
  h = F.relu(dense(p, f'{d}.Dense_1', F.relu(dense(p, f'{d}.Dense_0', z))))
  state = dense(p, f'{d}.Dense_2', h)
  x = z.reshape(-1, zH, zW, vqD).permute(0, 3, 1, 2)
  x = F.relu(upsample(p, f'{d}.Upsample_0', x))
  x = F.relu(upsample(p, f'{d}.Upsample_1', x))
  x = F.relu(conv(p, f'{d}.Conv_0', x))
  return conv(p, f'{d}.Conv_1', x)[:, 0], state


def attention(p, name, x, n_head):
  B, T, E = x.shape
  hs = E // n_head
  q, k, v = (t.reshape(B, T, n_head, hs).transpose(1, 2)
             for t in dense(p, f'{name}.qkv', x).split(E, -1))
  att = (q @ k.transpose(-1, -2)) / math.sqrt(hs)
  mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
  att = att.masked_fill(~mask, float('-inf')).softmax(-1)
  y = (att @ v).transpose(1, 2).reshape(B, T, E)
  return dense(p, f'{name}.proj', y)


def fbt_logits(p, z, action, n_layer, n_head):
  """FBT: codes (B, T, Z) and actions (B, T, A) -> token logits (B, T, Z);
  position t sees the codes and actions before t."""
  B, T, _ = z.shape
  x = dense(p, 'embed', z)
  x = torch.cat([x.new_zeros((B, 1, x.shape[-1])), x[:, :-1]], 1)
  a = torch.cat([action.new_zeros((B, 1, action.shape[-1])),
                 action[:, :-1]], 1)
  x = torch.cat([x, dense(p, 'cond_in', a)], -1) + p['pos_emb'][:, :T]
  for i in range(n_layer):
    b = f'block{i}'
    x = x + attention(p, f'{b}.attn', layer_norm(p, f'{b}.ln1', x), n_head)
    h = F.gelu(dense(p, f'{b}.Dense_0', layer_norm(p, f'{b}.ln2', x)),
               approximate='tanh')
    x = x + dense(p, f'{b}.Dense_1', h)
  return dense(p, 'dist_head.Dense_0', layer_norm(p, 'ln_f', x))


def onestep(pb, pf, lcd, proprio, action, i, u, temp, s):
  """The learned env's step: the window (B, W, ...) encoded, the FBT's
  token logits at position i, the tokens drawn as u < sigmoid(logits /
  temp), decoded. Returns (frame (B, H, W) 0/1, proprio (B, P), logits)."""
  B, W = lcd.shape[:2]
  z = encode(pb, lcd.reshape(B * W, *lcd.shape[2:]),
             proprio.reshape(B * W, -1)).reshape(B, W, -1)
  logits = fbt_logits(pf, z, action, s['n_layer'], s['n_head'])[:, i]
  bits = (u < torch.sigmoid(logits / temp)).to(lcd.dtype)
  frame, state = decode(pb, bits, s['zH'], s['zW'], s['vqD'])
  return (torch.sigmoid(frame) > 0.5).to(lcd.dtype), state, logits


def mlp(p, name, x):
  x = F.relu(dense(p, f'{name}.Dense_0', x))
  x = F.relu(dense(p, f'{name}.Dense_1', x))
  return dense(p, f'{name}.Dense_2', x)


def policy(p, state, goal):
  """PPO actor and critic: (mean, std, value)."""
  xa = torch.cat([state, dense(p, 'pi.goal_preproc', goal)], -1)
  xv = torch.cat([state, dense(p, 'v.goal_preproc', goal)], -1)
  return (mlp(p, 'pi.BaseMLP_0', xa), torch.exp(p['pi.log_std']),
          mlp(p, 'v.BaseMLP_0', xv)[..., 0])


def gaussian_logp(mu, std, act):
  lp = -0.5 * (((act - mu) / std) ** 2 + 2 * torch.log(std)
               + math.log(2 * math.pi))
  return lp.sum(-1)


def body_xy(pobs_keys):
  """Indices of the proprio entries the body-goal reward reads: every body
  position (keys matching '.*(x|y):p')."""
  import re
  return [i for i, k in enumerate(pobs_keys)
          if re.match('.*(x|y):p', k) is not None]


def rollout(w, start, draws, pools, steps, s, r, keep=()):
  """The fused dream epoch run freely for `steps` steps from `start` (the
  window batch {'lcd', 'proprio', 'action'} (B, W, ...), the pointer, the
  episode clock and the goals {'goal:lcd', 'goal:proprio'}), each step as
  the learned env serves it: the policy reads proprio at ptr - 1 and its
  action is written there, onestep predicts frame ptr, the window slides at
  W - 1, the body-goal reward is scored, a timeout (ep_len) resets every
  row from the prompt pool and a row that reached its goal or timed out
  takes a goal from the goal pool. draws: 'eps' (T, B, A), 'u' (T, B, Z),
  'pidx', 'gidx' (T, B); r: 'ep_len', 'goal_thresh', 'rew_scale', 'temp',
  'bidx'. Returns per step the observation read (proprio, goal proprio),
  the reward and done, and the window read at the steps in `keep` (after
  the action's write)."""
  wb = dict(start['wb'])
  ptr, ep_t = int(start['ptr']), int(start['ep_t'])
  goals = dict(start['goals'])
  W = wb['lcd'].shape[1]
  b = r['bidx']
  out = {'obs': [], 'goal': [], 'rew': [], 'done': [], 'windows': {}}
  for t in range(steps):
    ptr2 = min(ptr + 1, W - 1)
    slide = ptr2 == W - 1
    ep_t += 1
    timeout = ep_t >= r['ep_len']
    st, goal = wb['proprio'][:, ptr - 1], goals['goal:proprio']
    mu, std, _ = policy(w['ac'], st, goal)
    a = mu + std * draws['eps'][t].to(mu.dtype)
    wb = dict(wb, action=wb['action'].clone())
    wb['action'][:, ptr - 1] = a
    if t in keep:
      out['windows'][t] = {k: v.clone() for k, v in wb.items()}
    frame, pro, _ = onestep(w['bvae'], w['fbt'], wb['lcd'], wb['proprio'],
                            wb['action'], ptr, draws['u'][t], r['temp'], s)
    wb = dict(wb, lcd=wb['lcd'].clone(), proprio=wb['proprio'].clone())
    wb['lcd'][:, ptr] = frame
    wb['proprio'][:, ptr] = pro
    if slide:
      wb = {k: torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], 1)
            for k, v in wb.items()}
    delta = (goal[:, b] - pro[:, b]).abs().mean(-1)
    goal_done = delta < r['goal_thresh']
    success = goal_done & (not timeout)
    rew = (-delta + success.to(delta.dtype)) * r['rew_scale']
    done = goal_done | timeout
    out['obs'].append(st)
    out['goal'].append(goal)
    out['rew'].append(rew)
    out['done'].append(done)
    if timeout:
      p = draws['pidx'][t]
      fresh = {k: torch.zeros_like(v) for k, v in wb.items()}
      fresh['lcd'][:, 0] = pools['prompt']['lcd'][p]
      fresh['proprio'][:, 0] = pools['prompt']['proprio'][p]
      wb = fresh
    g = draws['gidx'][t]
    goals = {k: torch.where(done.view(-1, *([1] * (x.dim() - 1))),
                            pools['goal'][k.split(':')[1]][g], x)
             for k, x in goals.items()}
    ptr = ptr2 - 1 if slide else ptr2
    if timeout:
      ptr, ep_t = 1, 0
  return out
