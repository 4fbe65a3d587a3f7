"""Trainer: the generic train loop (the port of research/runners/trainer.py).

batch -> model.train_step -> periodic dry test batch + model.evaluate ->
periodic save. Batches come from the host-side RolloutDataset; every dump
of the logger's means is kept in `history` as (itr, {metric: mean}). A
frozen arbiter in G.arbiterdir feeds `evaluate` (`load_arbiter`).
G.profile writes a torch.profiler Chrome trace of the first steps.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import torch

from boxlcd_tpu_torch.data.dataset import load_ds
from boxlcd_tpu_torch.research import utils
from boxlcd_tpu_torch.research.nets.autoencoders import (
    ArbiterAE, MultiStepArbiter)
from boxlcd_tpu_torch.utils import AttrDict


def load_arbiter(G, env):
  """The first frozen arbiter (`*.frozen.pkl`, `Net.save_frozen`'s file) in
  G.arbiterdir as {'fn', 'module', 'window', 'kind'}, or None without one.

  A MultiStepArbiter's fn maps a (B, window, ...) clip batch to (features,
  action predictions), for the video models; an ArbiterAE's maps frames to
  (features, None), for the autoencoders (reference: trainer.py:20-52). It
  runs on env's device. Any other kind raises."""
  arbdir = Path(G.arbiterdir)
  cands = sorted(arbdir.glob('*.frozen.pkl')) if arbdir.is_dir() else []
  if not cands:
    return None
  with open(cands[0], 'rb') as f:
    blob = pickle.load(f)
  kind = blob['kind']
  aG = AttrDict(blob['G'])
  if kind == 'MultiStepArbiter':
    model = MultiStepArbiter(env, aG)
    window, fn = int(aG.window), model.forward_frozen
  elif kind == 'ArbiterAE':
    model = ArbiterAE(env, aG)
    window, fn = None, lambda batch: (model.encode(batch), None)
  else:
    raise ValueError(f'{cands[0]}: a frozen {kind} is not an arbiter')
  model.module.load_state_dict(blob['state_dict'])
  model.module.requires_grad_(False)
  print('LOADED ARBITER', cands[0], kind)
  return {'fn': fn, 'module': model.module, 'window': window, 'kind': kind}


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
    """Train to G.total_itr. With G.steps_per_dispatch = K > 1 each round
    takes K batches and K steps and logs the last step's metrics, where
    JAX stacks the K batches into one dispatch
    (research/runners/trainer.py:75-100): the same steps, logged at the
    same points (itr % log_n < K or itr <= K). G.profile traces the first
    min(50, total_itr) steps with torch.profiler (CPU activity, and CUDA
    activity on the card) into a Chrome trace in G.logdir."""
    G = self.G
    last_save = time.time()
    train_iter = iter(self.train_ds)
    test_iter = iter(self.test_ds)
    chunk = max(1, int(G.get('steps_per_dispatch', 1)))
    prof = self._start_profile() if G.get('profile', 0) else None
    # mid-run resume: the checkpoint carries the step counter
    itr = int(self.model.step)
    if itr:
      print(f'RESUMING at step {itr}')
    while itr < int(G.total_itr):
      with utils.Timer(self.logger, 'sample_batch'):
        batches = [next(train_iter) for _ in range(chunk)]
      with utils.Timer(self.logger, 'train_step'):
        for batch in batches:
          metrics = self.model.train_step(batch)
      itr += chunk
      self.logger.update(metrics)
      if itr % G.log_n < chunk or itr <= chunk:
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
      if prof is not None and itr == min(50, int(G.total_itr)):
        self._stop_profile(prof)
        prof = None
    if prof is not None:        # the steps never met min(50, total_itr)
      self._stop_profile(prof)
    self.model.save(G.logdir)

  def _start_profile(self):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if self.model.device.type == 'cuda':
      acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof

  def _stop_profile(self, prof):
    prof.stop()
    path = Path(self.G.logdir) / f'trace_{int(self.model.step)}.json'
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    print('PROFILE TRACE', path)
