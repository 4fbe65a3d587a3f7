"""What decides `correct` for dream traffic: the window's last call, as
delivered, against the plain reference (portbench/reference/dream.py and
the physics world's resets), on the weights and draws the benchmark made.

- `dream_frame_p50`, `dream_proprio_p50`: on the steps of the call that
  the driver recorded (drawn from the seed), the reference's onestep
  (BVAE encode of the window, the FBT's logits at the pointer, the tokens
  drawn with the call's uniforms, BVAE decode) from the window the program
  read, against the frame and proprio the program wrote. Per env the share
  of differing pixels (mean over the steps) and the largest proprio gap;
  the median over the envs (a token whose probability lies within rounding
  of its uniform may be drawn the other way, which changes that env's
  frame).
- `policy_gap`: over every step and env of the call, the largest gap of
  the action, value and log-probability the program's policy gave for the
  observation it delivered, against the reference's with the same normals.
- `pool_frame_diff`, `pool_gap`: the call's prompt and goal pools (real
  resets rendered by the program) against the reference's resets from the
  generator state they were drawn from: the share of differing pixels and
  the largest proprio gap.
- `carry_obs_p50`, `carry_reward_p50`, `carry_frame_p50`: the state the
  call carries from step to step. The reference runs the call freely from
  the state it started from (window, pointer, clock, goals), with its draws
  and pools, for `check.carry_steps` steps (all of them by default): its
  own policy, onestep, slide, reward, timeout reset and goal resample. Per
  env: the largest gap of the observation the program delivered (proprio
  and goal), the largest gap of the reward (a differing done counts 1),
  and the share of window pixels that differ on the recorded steps; each
  the median over the envs (a token drawn the other way at |p - u| within
  rounding sends that env on another path until its next reset).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dream as ref
from portbench.reference.episodes import _bf16
from portbench.reference.env import World

# the control (portbench/control.py): the nets run in float32 with TF32 off,
# so the program with TF32 on is the nearest precision below
CONTROL = 'tf32'


def _numbers(steps_got, steps_ref, pol_got, pol_ref, pools_got, pools_ref):
  px = np.stack([(g[0] != r[0]).float().mean((-1, -2)).cpu().numpy()
                 for g, r in zip(steps_got, steps_ref)])          # (S, B)
  pg = np.stack([(g[1] - r[1]).abs().amax(-1).cpu().numpy()
                 for g, r in zip(steps_got, steps_ref)])
  pol = max(float((g - r).abs().max()) for g, r in zip(pol_got, pol_ref))
  pf = np.mean([float((g[0] != r[0]).float().mean())
                for g, r in zip(pools_got, pools_ref)])
  pp = max(float((g[1] - r[1]).abs().max())
           for g, r in zip(pools_got, pools_ref))
  pol = float('inf') if np.isnan(pol) else pol
  cmp = {'dream_frame_p50': float(np.median(px.mean(0))),
         'dream_proprio_p50': float(np.median(np.nan_to_num(
             pg, nan=np.inf).max(0))),
         'policy_gap': pol, 'pool_frame_diff': float(pf),
         'pool_gap': float(pp)}
  seen = {'dream_frame_max': float(px.mean(0).max()),
          'dream_proprio_max': float(pg.max(0).max()),
          'dream_steps_checked': int(px.shape[0])}
  return cmp, seen


def _carry_numbers(got, ref):
  """The carry's numbers: `got` and `ref` each {'obs', 'goal', 'rew',
  'done'} (K, B, ...) and {'windows': {t: (B, W, H, Wd) frames}}."""
  gap = lambda a, b: np.nan_to_num(np.abs(a - b), nan=np.inf)
  obs = np.maximum(gap(got['obs'], ref['obs']).max(-1),
                   gap(got['goal'], ref['goal']).max(-1)).max(0)   # (B,)
  rew = np.maximum(gap(got['rew'], ref['rew']),
                   (got['done'] != ref['done']).astype(np.float64)).max(0)
  ts = sorted(set(got['windows']) & set(ref['windows']))
  if ts:
    px = np.mean([(got['windows'][t] != ref['windows'][t]).mean((1, 2, 3))
                  for t in ts], 0)
  else:
    px = np.full(obs.shape, np.inf)
  cmp = {'carry_obs_p50': float(np.median(obs)),
         'carry_reward_p50': float(np.median(rew)),
         'carry_frame_p50': float(np.median(px))}
  seen = {'carry_obs_max': float(obs.max()),
          'carry_reward_max': float(rew.max()),
          'carry_frame_max': float(px.max()),
          'carry_envs_apart': float((obs > 1e-3).mean()),
          'carry_steps': int(got['rew'].shape[0]),
          'carry_windows': len(ts)}
  return cmp, seen


def _params(ans, cfg, traffic):
  """The reward and the episode's settings as the configuration states
  them, the proprio entries the reward reads (from the reference's world)
  and the steps run freely."""
  world = World(cfg)
  ppo = cfg['ppo']
  K = int(traffic['check'].get('carry_steps', ans['draws']['u'].shape[0]))
  return world, {'ep_len': int(cfg['env_config']['ep_len']),
                 'goal_thresh': float(ppo['goal_thresh']),
                 'rew_scale': float(ppo['rew_scale']),
                 'temp': float(ppo['lenv_temp']),
                 'bidx': ref.body_xy(world.spec.pobs_keys)}, K


def _free(ans, w, s, r, K, device, dtype):
  """The reference's free run of the call's first K steps, on the host as
  numpy: {'obs', 'goal', 'rew', 'done', 'windows'}."""
  st = ans['start']
  start = {'wb': {k: v.to(device, dtype) for k, v in st['wb'].items()},
           'ptr': st['ptr'], 'ep_t': st['ep_t'],
           'goals': {k: v.to(device, dtype) for k, v in st['goals'].items()}}
  d = ans['draws']
  draws = {'eps': d['eps'].to(device, dtype),
           'u': d['u'].to(device, torch.float32),
           'pidx': d['pidx'].to(device), 'gidx': d['gidx'].to(device)}
  pools = {k: {f: v.to(device, dtype) for f, v in p.items()}
           for k, p in zip(('prompt', 'goal'), ans['pools'])}
  keep = [int(x['t']) for x in ans['steps'] if int(x['t']) < K]
  out = ref.rollout(w, start, draws, pools, K, s, r, keep)
  np_ = lambda x: x.float().cpu().numpy()
  return {'obs': np.stack([np_(x) for x in out['obs']]),
          'goal': np.stack([np_(x) for x in out['goal']]),
          'rew': np.stack([np_(x) for x in out['rew']]),
          'done': np.stack([x.cpu().numpy() for x in out['done']]),
          'windows': {t: np_(v['lcd']) for t, v in out['windows'].items()}}


def _reference(ans, cfg, traffic, device, dtype):
  """The reference's answers: per recorded step (frame, proprio), the
  policy's (action, value, logp) over the call, the pools (frame,
  proprio), and the free run of the call's first steps, computed in
  `dtype` (bfloat16: the control)."""
  s = dict(ans['shapes'], n_head=int(cfg['fbt']['n_head']))
  w = {k: {n: t.to(device, dtype) for n, t in v.items()}
       for k, v in ans['weights'].items()}
  world, r, K = _params(ans, cfg, traffic)
  steps = []
  with torch.no_grad():
    for x in ans['steps']:
      f, pr, _ = ref.onestep(
          w['bvae'], w['fbt'], x['lcd'].to(device, dtype),
          x['proprio'].to(device, dtype), x['action'].to(device, dtype),
          x['i'], x['u'].to(device, torch.float32), x['temp'], s)
      steps.append((f.float(), pr.float()))
    o = ans['traj'][0]
    st = torch.as_tensor(o[ans['state_key']], device=device).to(dtype)
    gl = torch.as_tensor(o[ans['goal_key']], device=device).to(dtype)
    mu, std, v = ref.policy(w['ac'], st, gl)
    a = mu + std * ans['draws']['eps'].to(device, dtype)
    logp = ref.gaussian_logp(mu, std, a)
    pol = [a.float(), v.float(), logp.float()]
    free = _free(ans, w, s, r, K, device, dtype)
  g = torch.Generator(device=ans['gen_device'])
  g.set_state(ans['gen_state'])
  pools = []
  for p in ans['pools']:
    n = p['lcd'].shape[0]
    u01 = torch.rand((n, world.spec.n, 4), generator=g,
                     device=ans['gen_device']).cpu()
    state = world.reset_from_uniforms(u01)
    if dtype == torch.bfloat16:
      state = _bf16(state)
    obs = world.observe_pose(state.is_circle, state.c, state.a)
    pools.append((obs['lcd'].float(), obs['proprio']))
  return steps, pol, pools, free


def _delivered_carry(ans, K):
  """The program's side of the carry: the observations, rewards and dones
  of the call's first K steps and the windows it read on the recorded
  steps among them, as numpy."""
  o, rew, done = ans['traj'][0], ans['traj'][2], ans['traj'][5]
  return {'obs': np.asarray(o[ans['state_key']][:K], np.float32),
          'goal': np.asarray(o[ans['goal_key']][:K], np.float32),
          'rew': np.asarray(rew[:K], np.float32),
          'done': np.asarray(done[:K], bool),
          'windows': {int(x['t']): x['lcd'].float().numpy()
                      for x in ans['steps'] if int(x['t']) < K}}


def judge(cfg, traffic, ans, seed, device, bf16=False):
  """(compared numbers, readings) of the window's last call; bf16=True
  puts the reference computed in bfloat16 in the program's place (the
  control)."""
  dev = torch.device(ans['gen_device'])
  steps_ref, pol_ref, pools_ref, free_ref = _reference(
      ans, cfg, traffic, dev, torch.float32)
  if bf16:
    steps_got, pol_got, pools_got, free_got = _reference(
        ans, cfg, traffic, dev, torch.bfloat16)
  else:
    steps_got = [(x['out_lcd'].to(dev).float(), x['out_proprio'].to(dev))
                 for x in ans['steps']]
    tr = ans['traj']
    pol_got = [torch.as_tensor(np.asarray(x), device=dev).float()
               for x in (tr[1], tr[3], tr[4])]
    pools_got = [(p['lcd'].float(), p['proprio']) for p in ans['pools']]
    free_got = _delivered_carry(ans, free_ref['rew'].shape[0])
  cmp, seen = _numbers(steps_got, steps_ref, pol_got, pol_ref, pools_got,
                       pools_ref)
  c2, s2 = _carry_numbers(free_got, free_ref)
  return dict(cmp, **c2), dict(seen, **s2)
