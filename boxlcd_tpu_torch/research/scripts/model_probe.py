"""Error-budget probe for the dream-env stack: how accurate are the BVAE
decode and the FBT one-step prediction relative to the body-goal success
threshold (G.goal_thresh, default 0.05 in normalized obs units)? (the port
of research/scripts/model_probe.py)

Measures, on freshly rolled real trajectories (fit_diag.real_batch: on the
card the megakernel's pose stream through the trajectory raster, on the
CPU the plain per-step physics):
  1. BVAE encode->decode proprio error (per-dim RMS + the reward's
     mean|delta| over the body-goal dims `bidx`),
  2. FBT teacher-forced one-step proprio error at the same dims,
  3. action sensitivity: |prediction(a) - prediction(-a)| at the root dims
     (does the dream respond to actions at all?).

    python -m boxlcd_tpu_torch.research.scripts.model_probe ppo --env=Luxo \
        --weightdir=<FBT dir> [--probe_T=25 --probe_B=64] [--device=cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.research.nets import net_map
from boxlcd_tpu_torch.research.nets._base import Net
from boxlcd_tpu_torch.research.rl.main import parse
from boxlcd_tpu_torch.research.scripts.fit_diag import real_batch


def body_goal_dims(raw):
  """Indices of the proprio keys the body-goal reward reads."""
  keys_xy = utils.filtlist(raw.pobs_keys, '.*(x|y):p')
  return np.asarray([raw.pobs_keys.index(x) for x in keys_xy])


@torch.no_grad()
def measure(model, batch, bidx, goal_thresh, u):
  """The three blocks on `batch` ({'lcd', 'proprio', 'action'}, (B, T,
  ...)); u: the onestep uniforms (B, z_size), the same for a and -a.
  Prints the report; returns its numbers."""
  host = lambda x: x.float().cpu().numpy()
  bvae = model.bvae
  B, T = batch['proprio'].shape[:2]
  W = int(model.G.window)
  out = {}
  # --- 1. BVAE decode error
  z = bvae.encode(batch, noise=False)
  dec = bvae.decode(z.reshape(-1, z.shape[-1]))
  true_pro = host(batch['proprio']).reshape(B * T, -1)
  dec_pro = host(dec['proprio'].mean).reshape(B * T, -1)
  err = dec_pro - true_pro
  mad = np.abs(err[:, bidx]).mean(-1)
  out.update(decode_rms=np.sqrt((err ** 2).mean(0)),
             decode_bidx_rms=float(np.sqrt((err[:, bidx] ** 2).mean())),
             decode_mad=mad, decode_below=float((mad < goal_thresh).mean()))
  print('== BVAE decode (B*T={} frames) =='.format(B * T))
  print('per-dim RMS:', np.round(out['decode_rms'], 4))
  print('bidx dims:', bidx, '-> RMS', np.round(out['decode_bidx_rms'], 4))
  print('reward-style mean|delta| over bidx: mean={:.4f} p50={:.4f} '
        'p90={:.4f} (goal_thresh={})'.format(
            mad.mean(), np.median(mad), np.percentile(mad, 90), goal_thresh))
  print('frac frames with decode-delta alone < thresh: {:.3f}'.format(
      out['decode_below']))

  # --- 2. FBT teacher-forced one-step error at frame i (mid-window)
  i = min(W - 1, T - 1) // 2 + 1
  wb = {k: batch[k][:, :W] for k in ('lcd', 'proprio', 'action')}
  if T < W:
    print(f'(probe_T={T} < window={W}; padding)')
    wb = {k: torch.cat([v, v.new_zeros((B, W - T) + v.shape[2:])], 1)
          for k, v in wb.items()}
  pred = host(model.onestep(dict(wb), i, None, 1.0, u=u)['proprio'][:, i])
  true = host(batch['proprio'][:, i])
  oerr = pred - true
  omad = np.abs(oerr[:, bidx]).mean(-1)
  out.update(onestep_frame=i, onestep_rms=np.sqrt((oerr ** 2).mean(0)),
             onestep_mad=omad)
  print(f'== FBT one-step (teacher-forced, frame {i}) ==')
  print('per-dim RMS:', np.round(out['onestep_rms'], 4))
  print('mean|delta| over bidx: mean={:.4f} p50={:.4f} p90={:.4f}'.format(
      omad.mean(), np.median(omad), np.percentile(omad, 90)))

  # --- 3. action sensitivity of the one-step prediction
  wb_neg = dict(wb)
  wb_neg['action'] = -wb['action']
  pred_neg = host(model.onestep(wb_neg, i, None, 1.0, u=u)['proprio'][:, i])
  dpred = np.abs(pred_neg - pred)
  out.update(sensitivity=dpred.mean(0),
             sensitivity_bidx=float(dpred[:, bidx].mean()))
  print('== action sensitivity (a vs -a, same draws) ==')
  print('mean |dproprio| per dim:', np.round(out['sensitivity'], 4))
  print('mean over bidx: {:.4f}'.format(out['sensitivity_bidx']))
  print('dim names:', model.env.pobs_keys)
  return out


def main(argv=None):
  argv = list(sys.argv[1:] if argv is None else argv)
  T, B = 25, 64
  keep = []
  for a in argv:
    if a.startswith('--probe_T='):
      T = int(a.split('=', 1)[1])
    elif a.startswith('--probe_B='):
      B = int(a.split('=', 1)[1])
    else:
      keep.append(a)
  G = parse(keep)
  raw = boxlcd_tpu_torch.env_map[G.env](G, device=G.device)
  dev = raw.device
  batch = real_batch(raw, torch.Generator(device=dev).manual_seed(
      int(G.seed) + 123), B, T)
  mG = Net.load_config(G.weightdir, 'FBT')
  model = net_map['FBT'](raw, mG)
  model.load(G.weightdir)
  u = torch.rand((B, model.z_size),
                 generator=torch.Generator(device=dev).manual_seed(7),
                 device=dev)
  return measure(model, batch, body_goal_dims(raw), G.goal_thresh, u)


if __name__ == '__main__':
  main()
