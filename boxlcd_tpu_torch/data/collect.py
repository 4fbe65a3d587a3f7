"""Batched rollout collection into barrel shards, on the card.

The port of boxlcd_tpu/data/collect.py, both configurations:
- the megakernel path (`make_mega_rollout_fn`, the default on the card): the
  physics of whole episodes in rollout-megakernel launches
  (engine/mega.py), then one trajectory-raster launch for all frames
  (render/traj_raster.py);
- the per-step path (`make_rollout_fn`, `collect_mega=0` and the CPU):
  reset and step run over a leading worlds axis, a Python loop runs over
  time, and every step renders its exact LCD frames through the per-frame
  raster kernel (render/cuda_raster.py);
- under `--mesh=dpN`, the per-step path with the worlds axis sharded over N
  devices (`make_sharded_rollout_fn`), as boxlcd_tpu shards it.
Whole [B, T, ...] episode tensors stay on the device until the host writes
the finished barrels.

Barrel layout matches the reference exactly (research/data.py:50-77): npz
`{timestamp}-{index}-{ep_len}.barrel.npz` with `action` [1000, T, act] plus
one entry per obs key [1000, T, ...], recorded as (o_t, a_t) pairs where the
final action is meaningless. With `barrel_format='native'` the shard is
boxlcd_tpu's uncompressed `{timestamp}-{index}-{ep_len}.tbarrel.npz`: the
same entries, but the frames bit-packed and XOR-delta coded by the barrelpack
codec (data/native) as `lcd_packed` + `lcd_shape`.
"""
from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from boxlcd_tpu_torch import parallel, trace
from boxlcd_tpu_torch.data import native
from boxlcd_tpu_torch.data.dataset import BARREL_SIZE, barrel_files
from boxlcd_tpu_torch.engine import mega, physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import raster, traj_raster


def pack_bits(lcd):
  """(..., W) bool frames -> (..., W // 8) uint8, MSB first along W (the
  np.unpackbits layout): a frame crosses to the host as 1 bit per pixel."""
  bitw = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                      device=lcd.device)
  return (lcd.reshape(*lcd.shape[:-1], -1, 8).to(torch.int32)
          * bitw).sum(-1).to(torch.uint8)


def unpack_bits(packed, n):
  """The inverse of pack_bits on the device: (..., B) uint8 -> (..., n)
  uint8 0/1, the first n of the 8 B bits (np.unpackbits' order)."""
  shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
  bits = (packed[..., None] >> shifts) & 1
  return bits.reshape(*packed.shape[:-1], -1)[..., :n]


def make_rollout_fn(env, policy_fn=None, pack_lcd=False):
  """Build (gen, batch) -> dict of [B, T, ...] episode tensors, and T.

  policy_fn(gen, obs_dict) -> (B, act) actions; defaults to uniform random
  actions (the reference's collection policy, data.py:57), which are drawn
  up front. pack_lcd packs frame bits into uint8 on the device (shape
  [..., W//8], np.unpackbits layout).

  The returned function has `.core(states, actions)`: the per-step path from
  given states, with actions a (B, T, act) tensor or a callable
  (t, obs) -> (B, act).
  """
  T = int(env.G.ep_len)
  pack_lcd = pack_lcd and env.lcd_w % 8 == 0

  def core(states, actions):
    act_fn = actions if callable(actions) else (lambda t, obs: actions[:, t])
    steps = []
    state = states
    for t in range(T):
      obs = Env.observe(env, state)
      act = act_fn(t, obs)
      # the physics alone: Env.step would also observe (and render) the
      # next state, which the next iteration does
      state = physics.step_world_batch(env.spec, state, act)
      lcd = pack_bits(obs['lcd']) if pack_lcd else obs['lcd'].to(torch.uint8)
      steps.append({**obs, 'lcd': lcd, 'action': act})
    return {k: torch.stack([s[k] for s in steps], 1) for k in steps[0]}

  def batch_rollout(gen, batch_size):
    # the functional core explicitly (WorldEnv overrides reset/step with the
    # stateful gym-style API)
    states = Env.reset(env, gen, batch_size)
    if policy_fn is not None:
      return core(states, lambda t, obs: policy_fn(gen, obs))
    return core(states, _random_actions(env, gen, batch_size, T))

  batch_rollout.core = core
  return batch_rollout, T


def _random_actions(env, gen, batch_size, T):
  u = torch.rand((batch_size, T, env.act_size), generator=gen,
                 device=env.device)
  return torch.clamp(u * 2.0 - 1.0, min=-1.0)


def make_mega_rollout_fn(env, pack_lcd=False):
  """The megakernel path (boxlcd_tpu's make_mega_rollout_fn): random-policy
  episodes as (gen, batch) -> dict of [B, T, ...] episode tensors, and T.

  All physics of an episode runs in one rollout-megakernel launch
  (engine/mega.py); the exact LCD frames come from one trajectory-raster
  launch over the T frames
  (render/traj_raster.py) where the spec, a frame of W <= 32 and the exact
  raster allow, else from observe_pose. Resets and actions are drawn
  exactly as make_rollout_fn draws them, so for one seed both
  configurations get the same inputs (no padding of B). The episode dict
  carries `obs_ok`: whether 16 spread frames, re-rendered one by one through
  raster.lcd_render (the per-frame kernel on the card), equal the
  trajectory's frames bit for bit.

  While tracing is on (boxlcd_tpu_torch.trace) a dispatch is the root span
  `collect.dispatch` over `collect.reset`, `collect.actions`,
  `collect.megakernel`, `collect.raster`, `collect.tripwire` and the
  `collect.glue` between them (motor speeds, the pose stream, observe_pose,
  the frames' unpacking, reshapes and pack_bits).

  The returned function has `.core(states, actions)` with actions a
  (B, T, act) tensor."""
  spec = env.spec
  T = int(env.G.ep_len)
  W, H = env.lcd_w, env.lcd_h
  pack_lcd = pack_lcd and W % 8 == 0
  rollout = mega.make_rollout(spec, T)
  use_tr = (traj_raster.supports(spec) and W <= 32
            and str(env.G.get('raster', 'exact')) == 'exact')
  trender = traj_raster.make_traj_render(spec, W, H) if use_tr else None

  def core(states, actions):
    B = states.c.shape[0]
    with trace.span('collect.glue'):
      ms = physics.motor_speeds(spec, actions).transpose(0, 1).contiguous()
      # o_t is the pose BEFORE action t: the reset pose, then the post-step
      # poses 0..T-2 (the final action of a barrel is meaningless)
      pose0 = torch.cat([states.c.permute(1, 2, 0),
                         states.a.T[:, None]], 1)[None]        # (1, n, 3, B)
    with trace.span('collect.megakernel'):
      _, traj = rollout(states, ms)
    with trace.span('collect.glue'):
      poses = torch.cat([pose0, traj['stream']])[:T]           # (T, n, 3, B)
      ic, cs, as_ = mega.flat_poses(poses, states.is_circle)
    if use_tr:
      with trace.span('collect.raster'):
        rows = trender.rows(poses, states.is_circle)             # (T, B, H)
      with trace.span('collect.glue'):
        obs = env.observe_pose(ic, cs, as_, lcd=False)
        obs['lcd'] = raster.unpack_rows(rows, W).reshape(T * B, H, W)
    else:
      with trace.span('collect.raster'):
        obs = env.observe_pose(ic, cs, as_)
    with trace.span('collect.tripwire'):
      chk = torch.as_tensor(np.linspace(0, T * B - 1, 16).astype(np.int64),
                            device=cs.device)
      want = raster.lcd_render(spec, ic[chk], cs[chk].contiguous(),
                               as_[chk].contiguous(), W, H)
      obs_ok = (obs['lcd'][chk] == want).all()
    with trace.span('collect.glue'):
      out = {k: v.reshape(T, B, *v.shape[1:]).transpose(0, 1)
             for k, v in obs.items()}
      out['lcd'] = pack_bits(out['lcd']) if pack_lcd else \
          out['lcd'].to(torch.uint8)
    out['action'] = actions
    out['obs_ok'] = obs_ok
    return out

  def batch_rollout(gen, batch_size):
    with trace.span('collect.dispatch'):
      with trace.span('collect.reset'):
        states = Env.reset(env, gen, batch_size)
      with trace.span('collect.actions'):
        actions = _random_actions(env, gen, batch_size, T)
      return core(states, actions)

  batch_rollout.core = core
  return batch_rollout, T


def make_sharded_rollout_fn(env, mesh, pack_lcd=False):
  """The per-step path over a `parallel.Mesh` (boxlcd_tpu's collect.py:
  248-260): (gen, batch) -> dict of [B, T, ...] episode tensors on the
  master, and T. The resets and actions are drawn once, at the global
  batch's shape, exactly as make_rollout_fn draws them; the worlds axis is
  then sharded, each device rolls its slice out on its own copy of the env
  with no cross-device traffic, and the episodes are gathered. The batch
  must divide over the devices."""
  fns = [make_rollout_fn(e, pack_lcd=pack_lcd)[0] for e in mesh.envs(env)]
  T = int(env.G.ep_len)

  def batch_rollout(gen, batch_size):
    mesh.check_divides(batch_size, 'collect batch')
    states = Env.reset(env, gen, batch_size)
    actions = _random_actions(env, gen, batch_size, T)
    return mesh.gather([fn.core(s, a) for fn, s, a in zip(
        fns, mesh.shard(states), mesh.shard(actions))])

  return batch_rollout, T


def rollout_batch(env, gen, batch_size, policy_fn=None):
  """Convenience: one batch of episodes as numpy arrays."""
  fn, _ = make_rollout_fn(env, policy_fn)
  return {k: v.cpu().numpy() for k, v in fn(gen, batch_size).items()}


def _fold_in(gen: torch.Generator, data: int) -> torch.Generator:
  """A new generator whose stream depends on `gen` and `data`."""
  seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                           device=gen.device).item())
  out = torch.Generator(device=gen.device)
  out.manual_seed((seed + int(data)) % 2 ** 63)
  return out


def write_barrel_file(folder, bi, T, lcd_w, traj, barrel_format='npz'):
  """Write one barrel of host arrays (`lcd` full frames or bit-packed along
  W) as `{timestamp}-{bi}-{T}.barrel.npz` (compressed, full bool frames) or,
  native, `.tbarrel.npz` (uncompressed, the codec's packed frames)."""
  traj = dict(traj)
  action = traj.pop('action')
  lcd = traj.pop('lcd')
  timestamp = datetime.now().strftime('%Y%m%dT%H%M%S')
  if barrel_format == 'native':
    # zlib on the host would dominate collection: the codec's ~8x smaller
    # payload is stored uncompressed
    if lcd.shape[-1] != lcd_w:  # device-packed bits go to the codec as is
      blob = native.pack_frames_packed(lcd, (*lcd.shape[:-1], lcd_w))
    else:
      blob = native.pack_frames(lcd.astype(bool))
    np.savez(Path(folder) / f'{timestamp}-{bi:05d}-{T}.tbarrel',
             action=action, lcd_packed=blob['data'], lcd_shape=blob['shape'],
             **traj)
    return
  if lcd.shape[-1] != lcd_w:  # device-packed bits -> full frames
    lcd = np.unpackbits(lcd, axis=-1)
  np.savez_compressed(Path(folder) / f'{timestamp}-{bi:05d}-{T}.barrel',
                      action=action, lcd=lcd.astype(bool), **traj)


def fill_barrels(env, num_barrels, prefix, G, gen, batch_size=None):
  """Fill `num_barrels` shards of BARREL_SIZE episodes each; returns the
  generator to continue from.

  As boxlcd_tpu does on an accelerator: on a CUDA device the megakernel path
  (make_mega_rollout_fn) when mega.supports(spec) and G.collect_mega
  (default 1); the per-step path (make_rollout_fn) on the CPU or with
  collect_mega=0. The megakernel path's render tripwire raises before any
  barrel is written. G.barrel_format is 'npz' (default) or 'native'. A mesh
  (`G.mesh`, 'dpN') selects the per-step path, as in boxlcd_tpu, with the
  worlds sharded over N devices (`make_sharded_rollout_fn`); the batch must
  divide over them."""
  mesh = parallel.parse_mesh(G.get('mesh', ''), env.device)
  barrel_format = G.get('barrel_format', 'npz')
  if barrel_format not in ('npz', 'native'):
    raise ValueError(f'unknown barrel format {barrel_format!r}')
  logdir = Path(G.logdir) / prefix
  logdir.mkdir(parents=True, exist_ok=True)
  # resume-aware: a rerun only collects the missing barrels (shards are
  # self-contained, so partial sets are valid)
  existing = len(barrel_files(logdir))
  if existing >= num_barrels:
    print(f'[collect] {prefix}: {existing} barrels already present, skipping')
    return gen
  num_barrels -= existing
  if existing:  # decorrelate the resumed episodes from the ones on disk
    gen = _fold_in(gen, existing)
    print(f'[collect] {prefix}: resuming, {num_barrels} barrels to go')
  batch_size = batch_size or int(G.get('num_envs', 0)) or 250
  # batches larger than one barrel fill several output files per dispatch
  if batch_size >= BARREL_SIZE:
    if batch_size % BARREL_SIZE:
      raise ValueError(f'batch size {batch_size} must be a multiple of '
                       f'{BARREL_SIZE}')
    per_dispatch, reps = batch_size // BARREL_SIZE, 1
  else:
    if BARREL_SIZE % batch_size:
      raise ValueError(f'batch size {batch_size} must divide barrel size '
                       f'{BARREL_SIZE}')
    per_dispatch, reps = 1, BARREL_SIZE // batch_size
  use_mega = False
  if mesh is not None:
    mesh.check_divides(batch_size, 'collect batch')
  elif env.device.type == 'cuda':
    use_mega = mega.supports(env.spec) and bool(int(G.get('collect_mega', 1)))
  if use_mega:
    fn, T = make_mega_rollout_fn(env, pack_lcd=True)
  elif mesh is not None:
    fn, T = make_sharded_rollout_fn(env, mesh, pack_lcd=True)
  else:
    fn, T = make_rollout_fn(env, pack_lcd=True)

  def collect_chunk():
    traj = {k: v.cpu().numpy() for k, v in fn(gen, batch_size).items()}
    ok = traj.pop('obs_ok', None)
    if ok is not None and not bool(ok):
      raise RuntimeError(
          'collect: the trajectory raster\'s frames differ from the per-frame '
          'render of the same poses; refusing to write barrels')
    return traj

  bi = 0
  while bi < num_barrels:
    t0 = time.time()
    chunks = [collect_chunk() for _ in range(reps)]
    traj = chunks[0] if reps == 1 else \
        {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    n = min(per_dispatch, num_barrels - bi)
    fps = n * BARREL_SIZE * T / (time.time() - t0)
    for j in range(n):
      sl = slice(j * BARREL_SIZE, (j + 1) * BARREL_SIZE)
      write_barrel_file(logdir, bi + j, T, env.lcd_w,
                        {k: v[sl] for k, v in traj.items()}, barrel_format)
    bi += n
    print(f'[collect] {prefix} barrel {bi}/{num_barrels} '
          f'({fps:,.0f} env-steps/s)')
  return gen


def collect(env_thunk, G):
  """Entry point mirroring the reference CLI mode (research/main.py:72-74).
  env_thunk: zero-arg callable producing the env (which holds its device)."""
  start = time.time()
  Path(G.logdir).mkdir(parents=True, exist_ok=True)
  env = env_thunk()
  gen = torch.Generator(device=env.device)
  gen.manual_seed(int(G.get('seed', 0)))
  gen = fill_barrels(env, int(G.test_barrels), 'test', G, gen)
  fill_barrels(env, int(G.train_barrels), 'train', G, gen)
  print('TOTAL COLLECT TIME', time.time() - start)
