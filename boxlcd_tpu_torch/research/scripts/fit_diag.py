"""FIT-collapse adjudication probe (the port of
research/scripts/fit_diag.py).

FIT is frame-level AR with a FACTORIZED Bernoulli pixel head: every pixel
of a frame is sampled independently given history. Hypothesis: FIT's
robot-env FVD collapse is this design's sampling incoherence, not a port
fault, because teacher-forced one-step predictions are fine and pixel
metrics (SSIM/PSNR) sit near FBT's; only the feature-space FVD, which is
sensitive to within-frame coherence, explodes.

Measures, on fresh real rollouts (`real_batch`):
  1. teacher-forced one-step next-frame quality (log-prob/pixel, accuracy,
     predictive entropy): is the LEARNED MODEL good?
  2. sample coherence: the isolated-on-pixel fraction (8-neighbourhood) of
     FIT samples vs FBT samples vs REAL frames: does independent pixel
     sampling speckle the frames?
  3. a truth/FIT/FBT sample strip PNG for eyeballing (an .npz without
     Pillow).

    python -m boxlcd_tpu_torch.research.scripts.fit_diag --env=Urchin \
        --fitdir=<FIT dir> [--fbtdir=<FBT dir>] [--B=16] [--device=cpu]

The env takes the FIT checkpoint's config (its frame size and solver
iterations). The real batch is the observation AFTER each of T uniform
random steps: on the card from the rollout megakernel's pose stream
(frames 1..T) through the trajectory raster and observe_pose, the main
path's route; on the CPU from the plain per-step physics and raster.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.engine import mega, physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import raster, traj_raster
from boxlcd_tpu_torch.research.nets import dists, net_map
from boxlcd_tpu_torch.research.nets._base import Net
from boxlcd_tpu_torch.research.utils import write_image


def rollout_batch(env, states, actions, plain=None):
  """T steps of every world from `states` under actions (B, T, act):
  {'lcd' (B, T, H, W) float, 'proprio' (B, T, P), 'action', 'c' (B, T, n,
  2), 'a' (B, T, n)}, each the observation after the step. plain: the
  per-step physics and the per-frame raster (the default off the card);
  else one megakernel launch and one trajectory-raster launch."""
  spec = env.spec
  B, T = actions.shape[:2]
  n, W, H = spec.n, env.lcd_w, env.lcd_h
  if plain is None:
    plain = not states.c.is_cuda
  if plain:
    c, a, lcd, pro = [], [], [], []
    st = states
    for t in range(T):
      st = physics.step_world_batch(spec, st, actions[:, t])
      obs = Env.observe(env, st)
      c.append(st.c)
      a.append(st.a)
      lcd.append(obs['lcd'])
      pro.append(obs['proprio'])
    stack = lambda xs: torch.stack(xs, 1)
    c, a, lcd, pro = stack(c), stack(a), stack(lcd), stack(pro)
  else:
    ms = physics.motor_speeds(spec, actions).transpose(0, 1).contiguous()
    _, traj = mega.make_rollout(spec, T)(states, ms)
    stream = traj['stream']                    # (T, n, 3, B): post-step
    rows = traj_raster.make_traj_render(spec, W, H).rows(stream,
                                                         states.is_circle)
    lcd = raster.unpack_rows(rows, W).reshape(T, B, H, W).transpose(0, 1)
    ic, cs, as_ = mega.flat_poses(stream, states.is_circle)
    pro = env.observe_pose(ic, cs, as_, lcd=False)['proprio']
    pro = pro.reshape(T, B, -1).transpose(0, 1)
    c = cs.reshape(T, B, n, 2).transpose(0, 1)
    a = as_.reshape(T, B, n).transpose(0, 1)
  return {'lcd': lcd.float(), 'proprio': pro, 'action': actions, 'c': c,
          'a': a}


def real_batch(env, gen, B, T, plain=None):
  """B fresh resets rolled T uniform random steps (`rollout_batch`)."""
  states = Env.reset(env, gen, B)
  actions = torch.rand((B, T, env.act_size), generator=gen,
                       device=env.device) * 2 - 1
  return rollout_batch(env, states, actions, plain)


def isolated_frac(frames):
  """Fraction of ON pixels (ink = 0 in lcd convention -> use 1-lcd) with no
  ON 8-neighbor: pure speckle."""
  on = 1.0 - np.asarray(frames)                    # ink = 1
  on = (on > 0.5).astype(np.float32)
  pad = np.pad(on, [(0, 0), (1, 1), (1, 1)])
  neigh = np.zeros_like(on)
  for dy in (-1, 0, 1):
    for dx in (-1, 0, 1):
      if dy == dx == 0:
        continue
      neigh += pad[:, 1 + dy:on.shape[1] + 1 + dy,
                   1 + dx:on.shape[2] + 1 + dx]
  iso = (on > 0) & (neigh == 0)
  denom = max(on.sum(), 1.0)
  return float(iso.sum() / denom)


@torch.no_grad()
def teacher_forced(fit, batch):
  """(log-prob/pixel, pixel accuracy, predictive entropy/pixel in nats)
  of FIT's teacher-forced next-frame logits on the batch."""
  B, T = batch['lcd'].shape[:2]
  lcd = batch['lcd'].reshape(B, T, -1)
  logits = fit.module(lcd, batch['action']).float()
  lp = float(dists.Bernoulli(logits).log_prob(lcd).mean())
  prob = torch.sigmoid(logits)
  acc = float(((prob > 0.5) == (lcd > 0.5)).float().mean())
  ent = float((-prob * torch.log(torch.clamp(prob, min=1e-8))
               - (1 - prob) * torch.log(torch.clamp(1 - prob, min=1e-8)))
              .mean())
  return lp, acc, ent


def strip(rows, T):
  """Truth / FIT / (FBT) rows of up to 20 frames as one (H', W', 3) image,
  8x upscaled."""
  cols = []
  for i in range(0, min(T, 20)):
    col = []
    for r in rows:
      col += [r[i], np.zeros_like(r[i][:1])]
    cols.append(np.concatenate(col[:-1], 0)[..., None].repeat(3, -1))
    cols.append(np.zeros_like(cols[-1][:, :1]))
  return np.concatenate(cols[:-1], 1).repeat(8, 0).repeat(8, 1)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--env', default='Urchin')
  parser.add_argument('--fitdir', required=True)
  parser.add_argument('--fbtdir', default='')
  parser.add_argument('--B', type=int, default=16)
  parser.add_argument('--outdir', default='logs/figs')
  parser.add_argument('--device', default=None)
  args = parser.parse_args(argv)
  device = utils.resolve_device(args.device)
  B = args.B

  mG = Net.load_config(args.fitdir, 'FIT')
  env = boxlcd_tpu_torch.env_map[args.env](mG, device=device)
  H, W = env.lcd_h, env.lcd_w
  T = int(mG.window)
  batch = real_batch(env, torch.Generator(device=device).manual_seed(0), B, T)
  fit = net_map['FIT'](env, mG)
  fit.load(args.fitdir)

  # --- 1. teacher-forced one-step quality
  lp, acc, ent = teacher_forced(fit, batch)
  print(f'== FIT teacher-forced (B={B}, T={T}) ==')
  print(f'log-prob/pixel {lp:.4f}  pixel acc {acc:.4f}  '
        f'pred entropy/pixel {ent:.4f} nats')
  out = {'log_prob': lp, 'acc': acc, 'entropy': ent}

  # --- 2. sample coherence
  host = lambda x: x.float().cpu().numpy()
  fs = fit.sample(torch.Generator(device=device).manual_seed(1), B,
                  action=batch['action'], prompts={'lcd': batch['lcd']},
                  prompt_n=3)
  fit_frames = host(fs['lcd']).reshape(-1, H, W)[B * 3:]
  real_frames = host(batch['lcd']).reshape(-1, H, W)
  out.update(iso_real=isolated_frac(real_frames),
             iso_fit=isolated_frac(fit_frames))
  print('isolated-pixel fraction: real %.4f  FIT %.4f'
        % (out['iso_real'], out['iso_fit']))
  rows = [host(batch['lcd'][0]), host(fs['lcd'][0])]
  if args.fbtdir:
    bG = Net.load_config(args.fbtdir, 'FBT')
    fbt = net_map['FBT'](env, bG)
    fbt.load(args.fbtdir)
    bs = fbt.sample(torch.Generator(device=device).manual_seed(1), B,
                    action=batch['action'],
                    prompts={k: batch[k] for k in ('lcd', 'proprio')},
                    prompt_n=3)
    fbt_frames = host(bs['lcd']).reshape(-1, H, W)[B * 3:]
    out['iso_fbt'] = isolated_frac(fbt_frames)
    print('isolated-pixel fraction: FBT %.4f' % out['iso_fbt'])
    rows.append(host(bs['lcd'][0]).reshape(-1, H, W))

  # --- 3. strip PNG: truth / FIT / (FBT)
  outdir = Path(args.outdir)
  outdir.mkdir(parents=True, exist_ok=True)
  out['strip'] = write_image(outdir / f'{args.env}_fit_diag.png',
                             strip(rows, T))
  print('wrote', out['strip'])
  return out


if __name__ == '__main__':
  main()
