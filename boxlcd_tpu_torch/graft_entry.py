"""Entry points of the port: a one-card compile check and a multi-card dry
run (the counterpart of the repo's __graft_entry__.py).

    python -m boxlcd_tpu_torch.graft_entry

runs `entry`'s forward on the card, then `dryrun_multichip` over every card
the host has. `dryrun_multichip(n)` raises when there are fewer than n
cards: it never falls back to a virtual mesh on the CPU (the JAX version
re-executes itself on one), which would hide the device. Tests ask for
logical CPU shards with `device='cpu'`.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch import parallel, utils


def _make_fbt(env, G):
  """FBT with a freshly initialized (untrained) frozen BVAE."""
  from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
  from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
  return FBT(env, G, bvae=BVAE(env, G))


def _tiny_config(device=None):
  from boxlcd_tpu_torch.research.define_config import config
  G = config()
  G.env = 'Urchin'
  G.window = 8
  G.n_embed = 64
  G.n_head = 2
  G.n_layer = 1
  G.hidden_size = 32
  G.nfilter = 16
  G.vqD = 8
  G.bs = 8
  G.vel_iters, G.pos_iters = 8, 4  # sharding dryrun, not physics parity
  G.device = str(utils.resolve_device(device))
  return G


def _prod_config(device=None):
  """The shapes the headline chains train at (research/scripts/r5/40: the
  512-dim FBT, 4 layers, 8 heads, window 25, bs 32, BVAE vqK=64/vqD=16/
  nfilter=16): the dry run proves these run under the dp mesh, not a toy.
  Only the dream epoch's steps are cut, not the model."""
  from boxlcd_tpu_torch.research.define_config import config
  G = config()
  G.env = 'Urchin'
  G.window = 25
  G.n_embed = 512
  G.n_head = 8
  G.n_layer = 4
  G.hidden_size = 128
  G.nfilter = 16
  G.vqK = 64
  G.vqD = 16
  G.bs = 32
  G.vel_iters, G.pos_iters = 8, 4  # sharding dryrun, not physics parity
  G.device = str(utils.resolve_device(device))
  return G


def entry(device=None):
  """(fn, example_args): the forward of the flagship model (FBT, tiny
  widths) on the card unless `device` says otherwise; fn.model is the
  model."""
  from boxlcd_tpu_torch.research.define_config import env_fn
  G = _tiny_config(device)
  env = env_fn(G)()
  model = _make_fbt(env, G)

  def fn(z, action):
    return model.module(z, action)

  fn.model = model
  z = torch.zeros((2, G.window, model.z_size), device=model.device)
  a = torch.zeros((2, G.window, model.act_n), device=model.device)
  return fn, (z, a)


def dryrun_multichip(n_devices: int, device=None) -> None:
  """One full FBT training step, a sharded collect chunk and a sharded
  dream-PPO epoch at the production shapes over a dp{n_devices} mesh (the
  batch, the worlds and the dream envs on 'dp'; the models replicated),
  each printing a `[dryrun]` line. Raises unless the host has n_devices
  cards (or `device='cpu'` asks for logical CPU shards).

  BOXLCD_DRYRUN_WORLDS (default 4096) sets the collect chunk's worlds and
  BOXLCD_DRYRUN_DREAM_ENVS (default 128) the dream envs, each cut down to
  a multiple of n_devices."""
  from boxlcd_tpu_torch.envs.env import Env
  from boxlcd_tpu_torch.research.define_config import env_fn
  spec = f'dp{n_devices}'
  mesh = parallel.parse_mesh(spec, 'cuda' if device is None else device)
  G = _prod_config(device)
  G.bs = max(G.bs, n_devices)
  G.mesh = spec
  env = env_fn(G)()
  model = _make_fbt(env, G)

  # --- one full training step (loss, gradients, clipped Adam), dp over the
  # batch ---------------------------------------------------------------------
  B, T = G.bs, G.window
  dev = model.device
  batch = {'lcd': torch.zeros((B, T, env.lcd_h, env.lcd_w), device=dev),
           'proprio': torch.zeros((B, T, model.proprio_n), device=dev),
           'action': torch.zeros((B, T, model.act_n), device=dev)}
  loss = float(model.train_step(batch)['loss/total'])
  print(f'[dryrun] train step ok on {n_devices} devices, loss={loss:.4f}')

  # --- the sharded batched-env rollout (the collect hot path): the
  # production world count on 'dp', two full env steps with observation
  # packing, every draw made at the whole batch's shape -----------------------
  n_worlds = int(os.environ.get('BOXLCD_DRYRUN_WORLDS', 4096))
  n_worlds -= n_worlds % n_devices
  gen = torch.Generator(device=dev).manual_seed(1)
  envs = mesh.envs(env)
  states = mesh.shard(Env.reset(env, gen, n_worlds))
  consumed = []
  for _ in range(2):
    acts = mesh.shard(torch.rand((n_worlds, env.act_size), generator=gen,
                                 device=dev) * 2 - 1)
    out = [Env.step(e, s, a) for e, s, a in zip(envs, states, acts)]
    states = [o[0] for o in out]
    consumed.append(mesh.gather([o[1]['lcd'].sum(1).sum(1).float()
                                 + o[1]['proprio'].sum(1) for o in out]))
  total = float(sum(c.sum() for c in consumed))
  if not np.isfinite(total):
    raise RuntimeError('dryrun collect chunk: non-finite observations')
  print(f'[dryrun] sharded collect chunk ok: {n_worlds} worlds over '
        f'{n_devices} devices (full obs consumed)')

  # --- the sharded dream-PPO epoch (RL inside the model): PPO's fused
  # RewardLenv(LearnedEnv(FBT)) epoch, dream envs on 'dp', the policy, FBT
  # and BVAE replicated --------------------------------------------------------
  from boxlcd_tpu_torch.research.rl.main import parse as rl_parse
  from boxlcd_tpu_torch.research.rl.ppo import PPO
  ne = int(os.environ.get('BOXLCD_DRYRUN_DREAM_ENVS', 128))
  ne -= ne % n_devices
  with tempfile.TemporaryDirectory(prefix='dryrun_fbt_') as tmp:
    wdir = Path(tmp)
    model.G.weightdir = wdir   # FBT reloads its frozen BVAE from here
    model.bvae.save(wdir)
    model.save(wdir)
    rG = rl_parse([
        '--env=Urchin', '--goals=1', '--autoreset=1', '--lenv=1',
        '--model=FBT', f'--weightdir={wdir}', f'--mesh={spec}',
        f'--num_envs={ne}', f'--steps_per_epoch={ne * 2}', '--bs=64',
        '--hidden_size=256', '--lenv_test=0', f'--logdir={wdir}/ppo',
        f'--device={G.device}', 'ppo'])
    algo = PPO(rG)
    algo._build_fused_lenv()
    algo._run_fused_lenv_epoch(np.zeros(ne), np.zeros(ne))
  print(f'[dryrun] sharded dream-PPO epoch ok: {ne} dream envs over '
        f'{n_devices} devices (mesh={spec})')


if __name__ == '__main__':
  fn, args = entry()
  out = fn(*args)
  print('entry ok', tuple(out.shape))
  dryrun_multichip(torch.cuda.device_count())
