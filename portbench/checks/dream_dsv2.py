"""What decides `correct` for dream traffic over the DeepSeek-V2 world model:
`checks/dream.py`'s comparisons of the window's last call, with this world
model's plain reference (`portbench/reference/dsv2.py`, float32, TF32 off)
in the FBT's place, and a comparison of logits on the program's own inputs.

- `logit_gap_p99`, `logit_gap_max`: on the recorded steps, the reference's
  logits at the pointer from the window codes and actions the program's
  transformer read (teacher-forced: no drawn token moves the path),
  against the program's logits there; the 99th percentile and the largest
  of |gap| over the steps, envs and codes.
- the rest as `checks/dream.py` defines them: the reference's onestep
  (BVAE encode, this model's logits, the draw, the decode) from the window
  the program read, the policy, the pools, and the call run freely for
  `check.carry_steps` steps.

The reference runs on the card after the program's state is freed, on the
world model's weights drawn again from the seed parameter by parameter
(`portbench/reference/dsv2_weights.py`), held in bfloat16 as the program
held them (30.6 GB) and read in float32 layer by layer. Its model
configuration, and the weights' shapes, come from the cell's
configuration file (`reference/dsv2.model_config`), not from the program;
a program whose module holds another configuration has no result.

The control (`CONTROL`, `judge(..., bf16=True)`, the flag's name as
`portbench/control.py` passes it): the reference with every matmul input
of the world model rounded through float8_e4m3fn, a precision below the
configuration's bfloat16, in the program's place.

The limits (portbench/limits/dream.urchin-dsv2lite.json), from 14 seeds of
the program and 8 of the control on an H100 (PERF.md):
- `logit_gap_p99` 0.2: the program read 0.0585-0.0775 (bfloat16 weights,
  activations and residual through 27 layers, logits of std ~1), the
  control 0.569-0.660; ~2.6x room above, ~2.8x below.
- `logit_gap_max` 0.6: the program read 0.129-0.326 (a token that the
  rounding routes to another expert at a near tie moves most), the
  control 1.08-1.39; ~1.8x room on each side.
- `policy_gap` 1e-4, `pool_gap` 1e-5, `pool_frame_diff` 1e-4, as
  dream.urchin-fbt holds them: the policy (float32) and the pools do not
  pass through the world model, so program and reference agree to float32
  rounding (~1e-6) whatever its precision.
The other numbers are kept as readings, not limits: a bfloat16 program
draws a token the other way wherever |p - u| is within its rounding, which
sends most envs on another path from the first step (the carry reads
alike for program and control), and the control's frames read as the
program's or overlap its readings (`dream_frame_p50` 0.0005-0.025 against
the control's 0.0039-0.128).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.checks import dream as base
from portbench.reference import dream as ref
from portbench.reference import dsv2 as ref_dsv2
from portbench.reference import dsv2_weights

CONTROL = 'float8'


@contextlib.contextmanager
def _world_model(cfg):
  """reference/dream.py's onestep and rollout with this world model in
  the FBT's place: its `fbt_logits` answered by `ref_dsv2.logits`. The
  last teacher-forced logits are reused where onestep asks for the same
  codes and actions."""
  memo = {}

  def logits(p, z, action, n_layer=None, n_head=None):
    hit = memo.get('in')
    if hit is not None and torch.equal(hit[0], z) and \
        torch.equal(hit[1], action):
      return memo['out']
    return ref_dsv2.logits(p, z, action, cfg)

  saved = ref.fbt_logits
  ref.fbt_logits = logits
  try:
    yield memo
  finally:
    ref.fbt_logits = saved


def _reference(ans, cfg, traffic, device, wm, mcfg, control):
  """As checks/dream.py's `_reference` in float32, with the world model
  `wm` of configuration `mcfg` (rounded through float8 where `control`);
  also the teacher-forced logits of each recorded step."""
  s = dict(ans['shapes'], n_layer=0, n_head=0)
  f32 = torch.float32
  w = {k: {n: t.to(device, f32) for n, t in v.items()}
       for k, v in ans['weights'].items()}
  w['fbt'] = wm
  world, r, K = base._params(ans, cfg, traffic)
  rnd = ref_dsv2.rounded(torch.float8_e4m3fn) if control else \
      contextlib.nullcontext()
  steps, lgs = [], []
  with torch.no_grad(), rnd, _world_model(mcfg) as memo:
    for x in ans['steps']:
      codes = x['codes'].to(device, f32)
      act = x['action'].to(device, f32)
      lg = ref_dsv2.logits(wm, codes, act, mcfg)
      memo.update({'in': (codes, act), 'out': lg})
      lgs.append(lg[:, x['i']].float())
      f, pr, _ = ref.onestep(
          w['bvae'], wm, x['lcd'].to(device, f32),
          x['proprio'].to(device, f32), act, x['i'],
          x['u'].to(device, f32), x['temp'], s)
      steps.append((f.float(), pr.float()))
    memo.clear()
    o = ans['traj'][0]
    st = torch.as_tensor(o[ans['state_key']], device=device).to(f32)
    gl = torch.as_tensor(o[ans['goal_key']], device=device).to(f32)
    mu, std, v = ref.policy(w['ac'], st, gl)
    a = mu + std * ans['draws']['eps'].to(device, f32)
    pol = [a, v, ref.gaussian_logp(mu, std, a)]
    free = base._free(ans, w, s, r, K, device, f32)
  g = torch.Generator(device=ans['gen_device'])
  g.set_state(ans['gen_state'])
  pools = []
  for p in ans['pools']:
    u01 = torch.rand((p['lcd'].shape[0], world.spec.n, 4), generator=g,
                     device=ans['gen_device']).cpu()
    state = world.reset_from_uniforms(u01)
    obs = world.observe_pose(state.is_circle, state.c, state.a)
    pools.append((obs['lcd'].float(), obs['proprio']))
  return steps, pol, pools, free, lgs


def _logit_numbers(got, want):
  gap = torch.cat([(g.to(w.device) - w).abs().flatten()
                   for g, w in zip(got, want)])
  gap = torch.nan_to_num(gap, nan=float('inf'))
  scale = torch.cat([w.flatten() for w in want]).std()
  cmp = {'logit_gap_p99': float(torch.quantile(gap[:2 ** 24].double(),
                                               0.99)),
         'logit_gap_max': float(gap.max())}
  seen = {'logit_gap_p50': float(gap.median()),
          'logit_ref_std': float(scale)}
  return cmp, seen


def judge(cfg, traffic, ans, seed, device, bf16=False):
  """(compared numbers, readings) of the window's last call; bf16=True
  puts the control (float8 matmul inputs) in the program's place."""
  dev = torch.device(ans['gen_device'])
  if dev.type == 'cuda':
    torch.cuda.empty_cache()
  mcfg = ref_dsv2.model_config(cfg)
  if ans['program_cfg'] != mcfg:
    raise ValueError(f'the program built {ans["program_cfg"]}, the '
                     f'configuration states {mcfg}')
  shapes = ref_dsv2.param_shapes(mcfg, ans['shapes']['zH'] *
                                 ans['shapes']['zW'] * ans['shapes']['vqD'],
                                 ans['shapes']['A'])
  wm = dsv2_weights.draw_all(shapes, ans['seed'], dev, torch.bfloat16)
  steps_ref, pol_ref, pools_ref, free_ref, lg_ref = _reference(
      ans, cfg, traffic, dev, wm, mcfg, control=False)
  if bf16:
    steps_got, pol_got, pools_got, free_got, lg_got = _reference(
        ans, cfg, traffic, dev, wm, mcfg, control=True)
  else:
    steps_got = [(x['out_lcd'].to(dev).float(), x['out_proprio'].to(dev))
                 for x in ans['steps']]
    tr = ans['traj']
    pol_got = [torch.as_tensor(np.asarray(x), device=dev).float()
               for x in (tr[1], tr[3], tr[4])]
    pools_got = [(p['lcd'].float(), p['proprio']) for p in ans['pools']]
    free_got = base._delivered_carry(ans, free_ref['rew'].shape[0])
    lg_got = [x['logits'] for x in ans['steps']]
  del wm
  cmp, seen = base._numbers(steps_got, steps_ref, pol_got, pol_ref,
                            pools_got, pools_ref)
  c2, s2 = base._carry_numbers(free_got, free_ref)
  c3, s3 = _logit_numbers(lg_got, lg_ref)
  return dict(cmp, **c2, **c3), dict(seen, **s2, **s3)
