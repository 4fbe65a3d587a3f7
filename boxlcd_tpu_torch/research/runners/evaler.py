"""Evaler: offline evaluation of a video model (the port of
research/runners/evaler.py).

Loads the model's weights fresh (or takes a model), then for each of 5 reps
over the test and train splits runs, batch by batch until `G.eval_n`
samples are pooled:
  unprompted: sample with random actions, burn the prompt, chop to the
    arbiter's window, keep the features and the arbiter's action log-MSE;
  prompted: sample from the batch's prompts and actions, burn the prompt,
    SSIM/PSNR, proprio log-MSE (envs with proprio), the arbiter's action
    log-MSE on the samples and on the true clips, feature cosdist;
then the FVD and precision / recall / F1 of the pooled features against the
true clips'. It writes {'<split>:<u|p>:<metric>': (mean, std)} over the
reps to logdir/logger.pkl and prints the table. It runs eagerly on the
model's device, under no_grad; a failure raises.
"""
from __future__ import annotations

import pickle
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch.data.dataset import load_ds
from boxlcd_tpu_torch.research import metrics as M
from boxlcd_tpu_torch.research.nets import net_map
from boxlcd_tpu_torch.research.nets._base import Net, to_device
from boxlcd_tpu_torch.research.nets.autoencoders._base import cosdist
from boxlcd_tpu_torch.research.nets.video_models import _base as vm
from boxlcd_tpu_torch.research.runners.trainer import load_arbiter


class Evaler:
  def __init__(self, model, env, G):
    self.env = env
    self.G = G
    if model is None:
      mG = Net.load_config(G.weightdir, G.model)
      # keep the checkpoint's own weightdir: FBT finds its frozen BVAE there
      mG.update(logdir=G.logdir, arbiterdir=G.arbiterdir, datadir=G.datadir)
      model = net_map[G.model](env, mG)
      model.load(G.weightdir)
    self.model = model
    self.arbiter = load_arbiter(G, env)
    self.train_ds, self.test_ds = load_ds(G)
    # samples pooled per rep for FVD and precision/recall
    self.N = int(G.get('eval_n', 2048))
    self.rep_s = []          # host seconds of each rep, both splits

  def _window(self, batch):
    w = self.model.block_size
    return to_device({k: v[:, :w] for k, v in batch.items()},
                     self.model.device)

  def _feats(self, clip, actions=None):
    if self.arbiter is None:
      return None, None
    return vm.arbiter_feats(self.arbiter, clip, actions)

  def unprompted(self, batch, gen):
    """Sample with random actions, burn the prompt, encode
    (reference: evaler.py:147-161)."""
    n = batch['lcd'].shape[0]
    pn = self.G.prompt_n
    action = vm.uniform_actions(
        gen, (n, self.model.block_size, self.model.act_n), self.model.device)
    sample = self.model.sample(gen, n, action=action)
    paz, almse = self._feats({k: sample[k][:, pn:] for k in ('lcd',
                                                              'proprio')},
                             action[:, pn:])
    return paz, {} if almse is None else {'action_log_mse': almse}

  def prompted(self, batch, gen):
    """Sample from the batch's prompts and actions (reference:
    evaler.py:163-198)."""
    n = batch['lcd'].shape[0]
    pn = self.G.prompt_n
    prompts = {k: v for k, v in batch.items() if k != 'action'}
    sample = self.model.sample(gen, n, action=batch['action'],
                               prompts=prompts, prompt_n=pn)
    metrics = {}
    lcd_t = batch['lcd']
    lcd_p = sample['lcd'].reshape(lcd_t.shape)
    metrics['ssim'] = M.ssim(lcd_p[:, pn:], lcd_t[:, pn:])
    metrics['psnr'] = M.psnr(lcd_p[:, pn:], lcd_t[:, pn:])
    pt, pp = batch['proprio'], sample['proprio']
    if self.env.pobs_size:  # passive envs have no proprio
      metrics['proprio_log_mse'] = torch.log(
          ((pt[:, pn:] - pp[:, pn:]) ** 2).mean())
    paz, almse = self._feats({'lcd': lcd_p[:, pn:], 'proprio': pp[:, pn:]},
                             batch['action'][:, pn:])
    taz, talmse = self._feats({'lcd': lcd_t[:, pn:], 'proprio': pt[:, pn:]},
                              batch['action'][:, pn:])
    if almse is not None:
      metrics['action_log_mse'] = almse
      metrics['true_action_log_mse'] = talmse
    if paz is not None:
      metrics['cosdist'] = cosdist(paz, taz)
    return paz, taz, metrics

  @torch.no_grad()
  def do_ds(self, ds, gen):
    logger = defaultdict(list)
    all_paz, all_upaz, all_taz = [], [], []
    seen = 0
    it = iter(ds)
    while seen < self.N:
      batch = self._window(next(it))
      upaz, um = self.unprompted(batch, gen)
      paz, taz, pm = self.prompted(batch, gen)
      for k, v in um.items():
        logger['u:' + k].append(float(v))
      for k, v in pm.items():
        logger['p:' + k].append(float(v))
      if paz is not None:
        all_upaz.append(upaz)
        all_paz.append(paz)
        all_taz.append(taz)
      seen += batch['lcd'].shape[0]
    if all_taz:
      taz = torch.cat(all_taz)
      for prefix, z in (('u:', torch.cat(all_upaz)),
                        ('p:', torch.cat(all_paz))):
        logger[prefix + 'fvd'].append(float(M.fid(z, taz)))
        pr = M.precision_recall_f1(taz[:5000], z[:5000])
        for k, v in pr.items():
          logger[prefix + k].append(float(v))
    return {k: float(np.mean(v)) for k, v in logger.items()}

  def run(self, reps=5):
    logger = defaultdict(list)
    for rep in range(reps):
      t0 = time.perf_counter()
      gen = torch.Generator(device=self.model.device).manual_seed(rep)
      for split, ds in (('test', self.test_ds), ('train', self.train_ds)):
        for mk, v in self.do_ds(ds, gen).items():
          logger[f'{split}:{mk}'].append(v)
      self.rep_s.append(time.perf_counter() - t0)
    final = {k: (float(np.mean(v)), float(np.std(v)))
             for k, v in logger.items()}
    logdir = Path(self.G.logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with open(logdir / 'logger.pkl', 'wb') as f:
      pickle.dump(final, f)
    for split in ('test', 'train'):
      for mode, label in (('u', 'Unprompted'), ('p', 'Prompted')):
        rows = {k.split(':', 2)[2]: v for k, v in final.items()
                if k.startswith(f'{split}:{mode}:')}
        if rows:
          print(f'== {split} {label}')
          for k, (m, s) in rows.items():
            print(f'{k:24s} {m:.4f} ± {s:.4f}')
    return final
