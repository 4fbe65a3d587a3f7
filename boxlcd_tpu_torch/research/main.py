"""Research CLI: collect / train / eval / viz / fiddle (the port of
research/main.py).

    python -m boxlcd_tpu_torch.research.main --mode=collect --env=Urchin ...
    python -m boxlcd_tpu_torch.research.main --mode=train --model=BVAE ...
    python -m boxlcd_tpu_torch.research.main --mode=eval --model=FBT \
        --weightdir=<FBT logdir> --arbiterdir=<MultiStepArbiter logdir> ...
    python -m boxlcd_tpu_torch.research.main --mode=viz --model=FBT \
        --weightdir=<FBT logdir> [--optimize_actions=1] [--interactive=1]
    python -m boxlcd_tpu_torch.research.main --mode=fiddle --model=BVAE \
        --weightdir=<BVAE logdir> --datadir=<barrels>
    python -m boxlcd_tpu_torch.research.main --ipython_mode=1 \
        [--model=FBT --weightdir=<FBT logdir>]

Keeps the reference's config-resume chain: flags -> datadir/hps.yaml
inheritance -> weightdir/hps.yaml inheritance -> derived lcd dims
(reference: main.py:31-55). Runs on the card unless --device=cpu, with
TF32 off. `--mesh=dpN` shards collection's worlds and training's batches
over N cards (N logical CPU shards with --device=cpu; `parallel.py`).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import yaml

from boxlcd_tpu_torch.parallel import parse_mesh
from boxlcd_tpu_torch.research.define_config import config, env_fn
from boxlcd_tpu_torch.utils import AttrDict, args_type, set_tf32

IGNORE = ['logdir', 'full_cmd', 'ipython_mode', 'weightdir', 'arbiterdir']


def parse_flags(argv=None):
  """Flags -> env-class defaults -> hps.yaml defaults -> CLI overrides
  (reference: research/main.py:23-56 — yaml feeds parser *defaults*, so
  explicit CLI flags always win)."""
  base = config()
  parser = argparse.ArgumentParser()
  for key, value in base.items():
    parser.add_argument(f'--{key}', type=args_type(value), default=value)
  temp = parser.parse_args(argv)
  from boxlcd_tpu_torch import env_map
  env_cls = env_map[temp.env]
  parser.set_defaults(**{k: v for k, v in env_cls.ENV_DG.items() if k in base})
  defaults = {}
  for src_dir in [temp.datadir, temp.weightdir]:
    hps = Path(src_dir) / 'hps.yaml'
    if hps.exists():
      with open(hps) as f:
        loaded = yaml.safe_load(f) or {}
      for key, val in loaded.items():
        if key in IGNORE or key not in base:
          continue
        if isinstance(base[key], Path):
          defaults[key] = Path(val)
        else:
          defaults[key] = type(base[key])(val)
  parser.set_defaults(**defaults)
  G = AttrDict(vars(parser.parse_args(argv)))
  for p in ['logdir', 'datadir', 'weightdir', 'arbiterdir', 'buffdir']:
    G[p] = Path(G[p])
  # --mesh=dpN: JAX's checks before any env is built (collect and train
  # shard over it; it never falls back to fewer devices)
  parse_mesh(G.mesh, G.device)
  # derived dims
  env = env_fn(G)()
  G.lcd_h = env.lcd_h
  G.lcd_w = env.lcd_w
  G.imsize = G.lcd_h * G.lcd_w
  return G, env


def train(G, env):
  """--mode=train: build (or auto-resume) G.model, then train it through
  the device-resident dataset (device_dataset=1) or the Trainer. Returns
  the model and the logged metrics as a list of (itr, {metric: value})."""
  from boxlcd_tpu_torch.research.nets import net_map
  model = net_map[G.model](env, G)
  print(f'{G.model}: {model.num_vars:,} params')
  if (Path(G.logdir) / f'{G.model}.pkl').exists():
    # auto-resume: a checkpoint in the logdir means a prior (possibly
    # killed) run of this config — restore weights, optimizer state, step
    # and generator, and continue toward total_itr
    model.load(G.logdir)
    print(f'RESUMING {G.model} at step {model.step}')
  if G.get('device_dataset', 0):
    # device-resident dataset + on-device window sampling: no host
    # round-trips per update
    from boxlcd_tpu_torch.data.device_dataset import (
        DeviceDataset, train_device)
    from boxlcd_tpu_torch.research import utils as rutils
    ds = DeviceDataset(Path(G.datadir) / 'train', device=model.device)
    print(f'dataset on device: {ds.n_episodes} episodes')
    writer = rutils.make_writer(G.logdir)
    history = []
    data = None
    if G.model in ('FBT', 'FBTDSV2'):
      data = {'z': model.precompute_z(ds.data, unpack=ds.unpack_lcd),
              'action': ds.data['action']}

    def cb(itr, line):
      history.append((itr, line))
      for k, v in line.items():
        writer.add_scalar(k, v, itr)
      writer.flush()

    chunk = int(G.get('steps_per_dispatch', 1))
    if chunk <= 1:  # default: log and check the step count every 100 steps
      chunk = min(100, int(G.total_itr))
    train_device(model, ds, int(G.total_itr), bs=G.bs, window=G.window,
                 chunk=chunk, log_every=int(G.log_n), logger_cb=cb,
                 data=data, save_dir=G.logdir)
    model.save(G.logdir)
    return model, history
  from boxlcd_tpu_torch.research.runners import Trainer
  trainer = Trainer(model, env, G)
  trainer.run()
  return model, trainer.history


def evaluate(G, env):
  """--mode=eval: the Evaler over G.weightdir's G.model with the frozen
  arbiter in G.arbiterdir; writes logdir/logger.pkl. Returns the Evaler
  and its table, {'<split>:<u|p>:<metric>': (mean, std)}."""
  from boxlcd_tpu_torch.research.runners import Evaler
  evaler = Evaler(None, env, G)
  return evaler, evaler.run()


def load_model(G, env):
  """G.model over `env` from the checkpoint in G.weightdir: its own config,
  with G's logdir and datadir (its weightdir stays the checkpoint's: FBT
  finds its frozen BVAE there), and its weights."""
  from boxlcd_tpu_torch.research.nets import net_map
  from boxlcd_tpu_torch.research.nets._base import Net
  mG = Net.load_config(G.weightdir, G.model)
  mG.update(logdir=G.logdir, datadir=G.datadir)
  model = net_map[G.model](env, mG)
  model.load(G.weightdir)
  return model


def visualize(G, env, n_rollouts=4):
  """--mode=viz: the InteractiveVizer with G.interactive (the headless
  Vizer's replay where no pyglet window opens), else the Vizer, over
  G.weightdir's G.model; gifs into G.logdir. Returns the runner and its
  rollouts."""
  from boxlcd_tpu_torch.research.runners import InteractiveVizer, Vizer
  viz_cls = InteractiveVizer if G.get('interactive', 0) else Vizer
  runner = viz_cls(load_model(G, env), env, G)
  return runner, runner.run(n_rollouts)


def fiddle(G, env):
  """--mode=fiddle: the Fiddler over G.weightdir's G.model on a test batch
  of G.datadir; writes G.logdir/vec_weights.pkl. Returns the weights."""
  from boxlcd_tpu_torch.research.runners import Fiddler
  return Fiddler(load_model(G, env), env, G).run()


def ipython(G, env):
  """ipython_mode: a REPL with env and G (and the model, where a weightdir
  is given) in scope (reference: research/main.py:77-83). IPython is
  imported here only."""
  model = None
  if G.get('weightdir') and str(G.weightdir) not in ('', '.'):
    model = load_model(G, env)
  import IPython
  IPython.embed(colors='neutral')
  return model


def main(argv=None):
  set_tf32(False)   # float32 is float32 on the card; bfloat16 is asked for
  G, env = parse_flags(argv)
  print(f'mode={G.mode} env={G.env} model={G.model} device={G.device}')
  if G.get('ipython_mode', 0):
    ipython(G, env)
    return
  if G.mode == 'collect':
    from boxlcd_tpu_torch.data import collect
    collect(env_fn(G), G)
  elif G.mode == 'train':
    train(G, env)
  elif G.mode == 'eval':
    evaluate(G, env)
  elif G.mode == 'viz':
    visualize(G, env)
  elif G.mode == 'fiddle':
    fiddle(G, env)
  else:
    raise ValueError(f'unknown mode {G.mode}')


if __name__ == '__main__':
  main()
