"""Trainer: the generic train loop (the port of research/runners/trainer.py).

batch -> model.train_step -> periodic dry test batch + model.evaluate ->
periodic save. Batches come from the host-side RolloutDataset; every dump
of the logger's means is kept in `history` as (itr, {metric: mean}).
"""
from __future__ import annotations

import time
from pathlib import Path

import torch

from boxlcd_tpu_torch.data.dataset import load_ds
from boxlcd_tpu_torch.research import utils


def load_arbiter(G, env):
  """None without a frozen arbiter (`*.frozen.pkl`) in G.arbiterdir; the
  arbiters are not ported yet, so one that is there raises."""
  arbdir = Path(G.arbiterdir)
  cands = sorted(arbdir.glob('*.frozen.pkl')) if arbdir.is_dir() else []
  if not cands:
    return None
  raise NotImplementedError(
      f'{cands[0]}: loading a frozen arbiter is not ported yet')


class Trainer:
  def __init__(self, model, env, G):
    self.model = model
    self.env = env
    self.G = G
    self.writer = utils.make_writer(G.logdir)
    self.train_ds, self.test_ds = load_ds(G)
    self.logger = utils.AutoLogger()
    self.arbiter = load_arbiter(G, env)
    self.history = []

  def run(self):
    G = self.G
    last_save = time.time()
    train_iter = iter(self.train_ds)
    test_iter = iter(self.test_ds)
    if G.get('profile', 0):
      raise NotImplementedError('G.profile: trace with torch.profiler '
                                'around Trainer.run instead')
    # mid-run resume: the checkpoint carries the step counter
    itr = int(self.model.step)
    if itr:
      print(f'RESUMING at step {itr}')
    while itr < int(G.total_itr):
      with utils.Timer(self.logger, 'sample_batch'):
        batch = next(train_iter)
      with utils.Timer(self.logger, 'train_step'):
        metrics = self.model.train_step(batch)
      itr += 1
      self.logger.update(metrics)
      if itr % G.log_n == 0 or itr == 1:
        with utils.Timer(self.logger, 'test'):
          test_batch = next(test_iter)
          tm = self.model.train_step(test_batch, dry=True)
          self.logger.update({f'test/{k}': v for k, v in tm.items()})
          em = self.model.evaluate(self.writer, test_batch, itr,
                                   arbiter=self.arbiter)
          self.logger.update(em)
        self.history.append(
            (itr, utils.dump_logger(self.logger, self.writer, itr, G)))
      if time.time() - last_save > 300 or itr % (G.log_n * G.save_n) == 0:
        self.model.save(G.logdir)
        last_save = time.time()
    self.model.save(G.logdir)
