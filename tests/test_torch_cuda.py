"""The CUDA kernels on the card vs their plain torch versions: the per-frame
LCD raster, the trajectory raster (bit for bit), the rollout megakernel
(within tests/test_mega.py's bounds) and the whole-batch solver kernel
(within tests/test_pallas.py's bounds); and the VecEnv on the card.

Marked `cuda`: these tests need an NVIDIA GPU and nvcc, and skip inside the
`cuda_device` fixture where there is none. Run them on the card with
`python -m pytest tests/test_torch_cuda.py -m cuda`.
"""
import dataclasses

import numpy as np
import pytest
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.engine import cuda_solver, mega, physics
from boxlcd_tpu_torch.envs.env import Env
from boxlcd_tpu_torch.render import cuda_raster, raster, traj_raster
from boxlcd_tpu_torch.research.wrappers import VecEnv
from boxlcd_tpu_torch.utils import AttrDict, set_tf32

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
ITERS = {'vel_iters': 8, 'pos_iters': 4}


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  return torch.device('cuda')


def _poses(env, batch, seed, dev):
  """Reset poses after two random-action steps, half of them shifted so
  bodies cross the frame's edges."""
  gen = torch.Generator(device=dev).manual_seed(seed)
  st = Env.reset(env, gen, batch)
  for _ in range(2):
    act = torch.rand((batch, env.act_size), generator=gen, device=dev) * 2 - 1
    st = physics.step_world_batch(env.spec, st, act)
  shift = (torch.rand((batch, 1, 2), generator=gen, device=dev) - 0.5) \
      * float(env.spec.width)
  c = torch.where(torch.arange(batch, device=dev)[:, None, None] % 2 == 1,
                  st.c + shift, st.c)
  return st.is_circle.contiguous(), c.contiguous(), st.a.contiguous()


@pytest.mark.parametrize('env_name,width,height', [
    ('Urchin', 32, 16), ('LuxoCube', 24, 16), ('Object3', 16, 16),
    ('Bounce2', 16, 16),
])
def test_kernel_equals_plain(cuda_device, env_name, width, height):
  env = boxlcd_tpu_torch.env_map[env_name](ITERS, device=cuda_device)
  ic, c, a = _poses(env, 3000, 0, cuda_device)
  cosa, sina = torch.cos(a), torch.sin(a)
  render = cuda_raster.make_batched_render(env.spec, width, height)
  before = trace.counter('lcd_raster.launches')
  got = render.kernel_rows(ic, c, cosa, sina)
  torch.cuda.synchronize()
  assert trace.counter('lcd_raster.launches') == before + 1
  want = raster.lcd_rows_plain(env.spec, ic, c, cosa, sina, width, height)
  assert got.dtype == torch.int32 and got.shape == (3000, height)
  assert int((got != want).sum()) == 0
  frames = raster.unpack_rows(got, width)
  assert not frames.all() and frames.any()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
  env = boxlcd_tpu_torch.env_map['Urchin'](ITERS, device=cuda_device)
  ic, c, a = _poses(env, 8, 1, cuda_device)
  render = cuda_raster.make_batched_render(env.spec, env.lcd_w, env.lcd_h)
  cosa, sina = torch.cos(a), torch.sin(a)
  with pytest.raises(ValueError):       # float64 poses
    render.kernel_rows(ic, c.double(), cosa, sina)
  with pytest.raises(ValueError):       # non-contiguous
    render.kernel_rows(ic, c.transpose(0, 1).contiguous().transpose(0, 1),
                       cosa, sina)
  with pytest.raises(ValueError):       # mixed devices
    render.kernel_rows(ic.cpu(), c, cosa, sina)


# tests/test_mega.py's bounds: (median, tail threshold, tail fraction)
MEGA_BOUNDS = {'Urchin': (1e-4, 5e-3, 0.03), 'Object3': (1.5e-3, 5e-2, 0.2)}
MEGA_FIELDS = ['c', 'a', 'v', 'w', 'sleep_time', 'wc_imp', 'j_imp', 'j_mot',
               'j_lim', 'j_state', 'prev_motor', 'pc_imp', 'pc_id']


def _mega_inputs(env, batch, T, dev):
  gen = torch.Generator(device=dev).manual_seed(0)
  st = Env.reset(env, gen, batch)
  acts = torch.cat([torch.rand((4, batch, env.act_size), generator=gen,
                               device=dev) * 2 - 1,
                    torch.zeros((T - 4, batch, env.act_size), device=dev)])
  return st, physics.motor_speeds(env.spec, acts).contiguous()


@pytest.mark.parametrize('env_name', ['Urchin', 'LuxoCube', 'Object3',
                                      'Bounce2'])
def test_traj_kernel_equals_plain(cuda_device, env_name):
  env = boxlcd_tpu_torch.env_map[env_name](ITERS, device=cuda_device)
  st, ms = _mega_inputs(env, 2048, 6, cuda_device)
  _, traj = mega.make_rollout(env.spec, 6)(st, ms)
  poses = traj['stream']
  # half of the worlds shifted so that bodies cross the frame's edges
  shift = torch.zeros_like(poses)
  shift[:, :, 0, 1::2] = 0.5 * float(env.spec.width)
  poses = (poses + shift).contiguous()
  W = min(env.lcd_w, 32)
  render = traj_raster.make_traj_render(env.spec, W, env.lcd_h)
  ang = poses[:, :, 2]
  cosa, sina = torch.cos(ang), torch.sin(ang)
  before = trace.counter('traj_raster.launches')
  got = render.kernel_rows(poses, cosa, sina, st.is_circle)
  torch.cuda.synchronize()
  assert trace.counter('traj_raster.launches') == before + 1
  want = render.plain_rows(poses, cosa, sina, st.is_circle)
  assert got.dtype == torch.int32 and got.shape == (6, 2048, env.lcd_h)
  assert int((got != want).sum()) == 0


@pytest.mark.parametrize('env_name', list(MEGA_BOUNDS))
def test_megakernel_within_bounds_of_plain(cuda_device, env_name):
  med_bound, tail_at, tail_frac = MEGA_BOUNDS[env_name]
  env = boxlcd_tpu_torch.env_map[env_name](ITERS, device=cuda_device)
  B, T = 1024, 8
  st, ms = _mega_inputs(env, B, T, cuda_device)
  rollout = mega.make_rollout(env.spec, T)
  before = trace.counter('mega_rollout.launches')
  new, traj = rollout.kernel_rollout(st, ms)
  torch.cuda.synchronize()
  assert trace.counter('mega_rollout.launches') == before + 1
  ref, ref_traj = rollout.plain_rollout(st, ms)
  assert torch.equal(new.ep_t, st.ep_t + T)
  for f in MEGA_FIELDS:
    err = (getattr(ref, f).float() - getattr(new, f).float()).abs()
    err = err.reshape(B, -1).max(1).values
    assert float(err.median()) < med_bound, f
    assert float((err > tail_at).float().mean()) < tail_frac, f
  for t in (0, 2):
    assert float((traj['c'][t] - ref_traj['c'][t]).abs().max()) < 1e-4
    assert float((traj['a'][t] - ref_traj['a'][t]).abs().max()) < 1e-4


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
  env = boxlcd_tpu_torch.env_map['Urchin'](ITERS, device=cuda_device)
  st, ms = _mega_inputs(env, 8, 5, cuda_device)
  rollout = mega.make_rollout(env.spec, 5)
  with pytest.raises(ValueError):       # float64 motor speeds
    rollout.kernel_rollout(st, ms.double())
  with pytest.raises(ValueError):       # non-contiguous motor speeds
    rollout.kernel_rollout(st, ms.transpose(1, 2).contiguous().transpose(1, 2))
  with pytest.raises(ValueError):       # a state field on the CPU
    rollout.kernel_rollout(st._replace(v=st.v.cpu()), ms)
  with pytest.raises(ValueError):       # a spec beyond the kernel's maxima
    mega.make_rollout(dataclasses.replace(env.spec, n=mega.MAX_BODIES + 1), 5)
  _, traj = rollout.kernel_rollout(st, ms)
  poses = traj['stream']
  render = traj_raster.make_traj_render(env.spec, env.lcd_w, env.lcd_h)
  cosa, sina = torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])
  with pytest.raises(ValueError):       # float64 poses
    render.kernel_rows(poses.double(), cosa, sina, st.is_circle)
  with pytest.raises(ValueError):       # non-contiguous poses
    render.kernel_rows(poses.transpose(0, 1).contiguous().transpose(0, 1),
                       cosa, sina, st.is_circle)
  with pytest.raises(ValueError):       # mixed devices
    render.kernel_rows(poses, cosa, sina, st.is_circle.cpu())


# tests/test_pallas.py's bounds: the velocity hook within 1e-4 on v, w, c,
# a; the substep hook within 2e-3 on its fields (NGS exit flags are hard
# thresholds: a one-ulp flip costs one position iteration, ~5e-4 on c)
SOLVER_FIELDS = {
    'velocity': (1e-4, ['v', 'w', 'c', 'a']),
    'substep': (2e-3, ['v', 'w', 'c', 'a', 'wc_imp', 'pc_imp', 'j_imp',
                       'j_mot', 'j_lim', 'sleep_time']),
}


@pytest.mark.parametrize('env_name', ['UrchinBall', 'LuxoCube'])
@pytest.mark.parametrize('hook', ['velocity', 'substep'])
def test_solver_kernel_within_bounds_of_plain(cuda_device, env_name, hook):
  env = boxlcd_tpu_torch.env_map[env_name](ITERS, device=cuda_device)
  spec = env.spec
  gen = torch.Generator(device=cuda_device).manual_seed(0)
  st = Env.reset(env, gen, 1024)
  act = torch.rand((1024, env.act_size), generator=gen,
                   device=cuda_device) * 2 - 1
  for _ in range(3):
    st = physics.step_world_batch(spec, st, act)
  solver = (cuda_solver.make_batched_solver(spec) if hook == 'velocity'
            else cuda_solver.make_substep_solver(spec))
  before = trace.counter(f'solver.{hook}.launches')
  got = physics.step_world_batch(spec, st, act, **{f'{hook}_solver': solver})
  torch.cuda.synchronize()
  assert trace.counter(f'solver.{hook}.launches') == before + spec.substeps
  want = physics.step_world_batch(spec, st, act)
  bound, fields = SOLVER_FIELDS[hook]
  for f in fields:
    err = float((getattr(got, f) - getattr(want, f)).abs().max())
    assert err < bound, (f, err)


def test_solver_kernel_with_dropped_second_points(cuda_device):
  """Contacts whose second velocity point Box2D drops (zero masses and
  impulse, no block solve, both points still touching): the kernel runs
  every slot and must give the plain solves' result."""
  from chip_smoke import drop_second_points
  env = boxlcd_tpu_torch.env_map['LuxoCube'](ITERS, device=cuda_device)
  spec = env.spec
  gen = torch.Generator(device=cuda_device).manual_seed(1)
  st = Env.reset(env, gen, 1024)
  act = torch.rand((1024, env.act_size), generator=gen,
                   device=cuda_device) * 2 - 1
  for _ in range(3):
    st = physics.step_world_batch(spec, st, act)
  K = physics.consts(spec, cuda_device)
  b, aux = physics._presolve(spec, K, st, physics.motor_speeds(spec, act))
  assert int((b.w_nmass > 0).all(-1).sum()) > 0
  b = drop_second_points(b)
  solver = cuda_solver.make_substep_solver(spec)
  (got, c, a), (want, c0, a0) = (solver.kernel_solve(st, b, aux),
                                 solver.plain_solve(st, b, aux))
  torch.cuda.synchronize()
  for g, w in zip((got.v, got.w, got.wc, got.pc, c, a),
                  (want.v, want.w, want.wc, want.pc, c0, a0)):
    assert float((g - w).abs().max()) < 2e-3


def test_vec_env_on_the_card_launches_the_raster(cuda_device):
  env = boxlcd_tpu_torch.env_map['Luxo'](ITERS, device=cuda_device)
  venv = VecEnv(env, 8, AttrDict(goal_thresh=0.05, rew_scale=1.0),
                goal_mode='body')
  obs = venv.reset()
  before = trace.counter('lcd_raster.launches')
  obs, rew, done, infos = venv.step(np.zeros((8, env.act_size), np.float32))
  torch.cuda.synchronize()
  assert trace.counter('lcd_raster.launches') > before
  assert isinstance(obs['lcd'], np.ndarray) and obs['lcd'].shape == (
      8, env.lcd_h, env.lcd_w)
  assert rew.shape == (8,) and len(infos) == 8


# The redesigned physics kernels (a group of lanes per world): tests/
# test_mega.py's six envs and CrabCube (32 lanes a world, the largest group),
# on ragged batches that leave a block part empty.
REDESIGN_ENVS = ['Urchin', 'Luxo', 'LuxoCube', 'UrchinBall', 'Bounce2',
                 'Object3', 'CrabCube']
RAGGED = [1, 33, 1000]


@pytest.mark.parametrize('B', RAGGED)
@pytest.mark.parametrize('env_name', REDESIGN_ENVS)
def test_megakernel_groups_match_plain(cuda_device, env_name, B):
  med_bound, tail_at, tail_frac = MEGA_BOUNDS.get(env_name,
                                                  MEGA_BOUNDS['Urchin'])
  env = boxlcd_tpu_torch.env_map[env_name](ITERS, device=cuda_device)
  T = 6
  st, ms = _mega_inputs(env, B, T, cuda_device)
  rollout = mega.make_rollout(env.spec, T)
  before = trace.counter('mega_rollout.launches')
  new, traj = rollout.kernel_rollout(st, ms)
  torch.cuda.synchronize()
  assert trace.counter('mega_rollout.launches') == before + 1
  ref, ref_traj = rollout.plain_rollout(st, ms)
  for f in MEGA_FIELDS:
    err = (getattr(ref, f).float() - getattr(new, f).float()).abs()
    err = err.reshape(B, -1).max(1).values
    assert float(err.median()) < med_bound, f
    assert float((err > tail_at).float().mean()) < tail_frac or B == 1, f
  for t in (0, 2):
    assert float((traj['c'][t] - ref_traj['c'][t]).abs().max()) < 1e-4
    assert float((traj['a'][t] - ref_traj['a'][t]).abs().max()) < 1e-4
  assert torch.equal(traj['c'][-1], new.c) and torch.equal(traj['a'][-1], new.a)


@pytest.mark.parametrize('hook', ['velocity', 'substep'])
@pytest.mark.parametrize('B', RAGGED)
@pytest.mark.parametrize('env_name', REDESIGN_ENVS)
def test_solver_kernel_groups_equal_plain(cuda_device, env_name, B, hook):
  """The solver kernels against the plain solves on the same bundle: equal
  bit for bit (the kernels keep the plain op order in every world)."""
  env = boxlcd_tpu_torch.env_map[env_name](ITERS, device=cuda_device)
  spec = env.spec
  gen = torch.Generator(device=cuda_device).manual_seed(2)
  st = Env.reset(env, gen, B)
  act = torch.rand((B, env.act_size), generator=gen,
                   device=cuda_device) * 2 - 1
  for _ in range(3):
    st = physics.step_world_batch(spec, st, act)
  K = physics.consts(spec, cuda_device)
  b, aux = physics._presolve(spec, K, st, physics.motor_speeds(spec, act))
  if hook == 'velocity':
    solver = cuda_solver.make_batched_solver(spec)
    got, want = (solver.kernel_solve(b),), (solver.plain_solve(b),)
  else:
    solver = cuda_solver.make_substep_solver(spec)
    got, want = solver.kernel_solve(st, b, aux), solver.plain_solve(st, b, aux)
  torch.cuda.synchronize()
  for f in ('v', 'w', 'j_imp', 'j_mot', 'j_lim', 'wc', 'pc'):
    assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
  for g, w in zip(got[1:], want[1:]):
    assert torch.equal(g, w)


@pytest.mark.parametrize('threads', [32, 64, 128])
def test_solver_kernels_at_every_block_size(cuda_device, threads):
  """The solver path's batch at each block size launch_geometry picks from:
  equal to the plain solves at every one."""
  env = boxlcd_tpu_torch.env_map['Urchin'](ITERS, device=cuda_device)
  spec = env.spec
  gen = torch.Generator(device=cuda_device).manual_seed(3)
  st = Env.reset(env, gen, 4096)
  act = torch.rand((4096, env.act_size), generator=gen,
                   device=cuda_device) * 2 - 1
  for _ in range(3):
    st = physics.step_world_batch(spec, st, act)
  K = physics.consts(spec, cuda_device)
  b, aux = physics._presolve(spec, K, st, physics.motor_speeds(spec, act))
  sub = cuda_solver.make_substep_solver(spec)
  vel = cuda_solver.make_batched_solver(spec)
  got = sub.kernel_solve(st, b, aux, threads=threads)
  want = sub.plain_solve(st, b, aux)
  got_v = vel.kernel_solve(b, threads=threads)
  want_v = vel.plain_solve(b)
  torch.cuda.synchronize()
  for g, w in zip((*got[0][:7], got[1], got[2], *got_v[:7]),
                  (*want[0][:7], want[1], want[2], *want_v[:7])):
    assert torch.equal(g, w)
  assert sub.occupancy(4096, threads) > 0 and vel.occupancy(4096, threads) > 0


# The redesigned raster kernels (a tile of lanes per frame, setup once per
# body, rows only where a body is): CrabCube cut to 32 wide (18 bodies, one
# of 6 vertices: the NV = 8 instantiation) at 32 rows, and at 16 rows (more
# bodies than a tile has lanes).
@pytest.mark.parametrize('width,height', [(32, 32), (32, 16)])
def test_rasters_on_crabcube_equal_plain(cuda_device, width, height):
  env = boxlcd_tpu_torch.env_map['CrabCube'](ITERS, device=cuda_device)
  ic, c, a = _poses(env, 3000, 4, cuda_device)
  cosa, sina = torch.cos(a), torch.sin(a)
  render = cuda_raster.make_batched_render(env.spec, width, height)
  assert cuda_raster.launch_geometry(env.spec, 3000, height).nv == 8
  got = render.kernel_rows(ic, c, cosa, sina)
  want = raster.lcd_rows_plain(env.spec, ic, c, cosa, sina, width, height)
  torch.cuda.synchronize()
  assert int((got != want).sum()) == 0
  st, ms = _mega_inputs(env, 1024, 6, cuda_device)
  _, traj = mega.make_rollout(env.spec, 6)(st, ms)
  shift = torch.zeros_like(traj['stream'])
  shift[:, :, 0, 1::2] = 0.5 * float(env.spec.width)
  poses = (traj['stream'] + shift).contiguous()
  cosa, sina = torch.cos(poses[:, :, 2]), torch.sin(poses[:, :, 2])
  trender = traj_raster.make_traj_render(env.spec, width, height)
  got = trender.kernel_rows(poses, cosa, sina, st.is_circle)
  want = trender.plain_rows(poses, cosa, sina, st.is_circle)
  torch.cuda.synchronize()
  assert int((got != want).sum()) == 0
  frames = raster.unpack_rows(got, width)
  assert not frames.all() and frames.any()


@pytest.fixture
def float32_card(cuda_device):
  """TF32 off for the test (the training CLI's setting), restored after."""
  old = (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)
  set_tf32(False)
  yield cuda_device
  torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# The world models on the card (float32, TF32 off) against the same modules
# on the CPU from the same state dict, at random init: logits within 1e-3,
# losses within 1e-4 relative (chip_smoke.py holds its trained models
# tighter); cached and uncached sampling bit for bit equal on the card too.
def test_world_models_on_card_match_cpu(float32_card):
  cuda_device = float32_card
  from boxlcd_tpu_torch.research.define_config import config
  from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
  from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
  models = {}
  for dev in ('cpu', cuda_device):
    env = boxlcd_tpu_torch.env_map['Urchin'](ITERS, device=dev)
    G = config()
    G.update(hidden_size=64, vqK=64, vqD=16, nfilter=16, window=12, bs=8,
             n_layer=2, n_head=8, n_embed=128, lr=5e-4, device=str(dev),
             wh_ratio=env.G.wh_ratio, lcd_base=env.G.lcd_base)
    bvae = BVAE(env, G)
    models[str(dev)] = (bvae, FBT(env, G, bvae=bvae))
  rng = np.random.default_rng(0)
  P, A = env.pobs_size, env.act_size
  batch = {'lcd': (rng.random((8, 12, 16, 32)) > 0.5).astype(np.float32),
           'proprio': rng.uniform(-1, 1, (8, 12, P)).astype(np.float32),
           'action': rng.uniform(-1, 1, (8, 12, A)).astype(np.float32)}
  u = torch.rand((96, 4, 8, 16), generator=torch.Generator().manual_seed(1))
  out = {}
  for dev, (bvae, fbt) in models.items():
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.no_grad():
      z = bvae.encode(b)
      logits = fbt.module(z, b['action'])
      out[dev] = (bvae.decode(z.reshape(-1, bvae.z_size))['lcd'].logits,
                  logits, float(bvae.loss_fn(b, u=u.to(dev))[0]),
                  float(fbt.loss_fn(b)[0]))
  (bl, fl, lb, lf), (bl_c, fl_c, lb_c, lf_c) = out['cuda'], out['cpu']
  assert float((bl.cpu() - bl_c).abs().max()) < 1e-3
  assert float((fl.cpu() - fl_c).abs().max()) < 1e-3
  assert abs(lb - lb_c) < 1e-4 * abs(lb_c)
  assert abs(lf - lf_c) < 1e-4 * abs(lf_c)
  _, fbt = models['cuda']
  g = torch.Generator(device=cuda_device).manual_seed(3)
  state = g.get_state()
  a = fbt.sample(g, 4, use_cache=True)
  g.set_state(state)
  c = fbt.sample(g, 4, use_cache=False)
  assert all(torch.equal(a[k], c[k]) for k in a)


def test_native_codec_builds_and_round_trips(cuda_device):
  from boxlcd_tpu_torch.data import native
  assert native.build().exists()
  frames = np.random.default_rng(0).random((3, 10, 16, 32)) > 0.6
  assert (native.unpack_frames(native.pack_frames(frames)) == frames).all()


def _bench_chunks(dev, kind, T=2, B=1024):
  """bench.py's `kind` chunk and its jnp chunk from the same states and
  actions: (kind's (states, consumed), jnp's, the launches kind made)."""
  from boxlcd_tpu_torch import bench
  env = bench.make_env('Urchin', 8, 4, dev)
  gen = torch.Generator(device=dev).manual_seed(4)
  st = Env.reset(env, gen, B)
  acts = torch.rand((T, B, env.act_size), generator=gen, device=dev) * 2 - 1
  torch.cuda.synchronize()
  kernels = ('mega_rollout', 'traj_raster', 'lcd_raster', 'solver.substep')
  before = [trace.counter(f'{k}.launches') for k in kernels]
  got = bench.make_chunk(env, kind, T)(st, acts)
  torch.cuda.synchronize()
  after = [trace.counter(f'{k}.launches') for k in kernels]
  want = bench.make_chunk(env, 'jnp', T)(st, acts)
  return got, want, [a - b for a, b in zip(after, before)], env


def test_bench_mega_chunk_against_jnp(cuda_device):
  """The megakernel + trajectory raster chunk: one launch of each; its
  consumed sum within 1e-3 of the plain step's (the megakernel holds
  tests/test_mega.py's bounds, not bits), its poses within 1e-4."""
  (st, s), (st_j, s_j), launches, _ = _bench_chunks(cuda_device, 'mega')
  assert launches == [1, 1, 0, 0]
  assert abs(float(s) - float(s_j)) <= 1e-3 * abs(float(s_j))
  assert float((st.c - st_j.c).abs().max()) < 1e-4


def test_bench_sub_chunk_equals_jnp(cuda_device):
  """The substep-kernel chunk equals the plain step's bit for bit (the
  kernel is bit-equal to the plain solves), with substeps x T solver
  launches and one lcd raster launch a step."""
  (st, s), (st_j, s_j), launches, env = _bench_chunks(cuda_device, 'sub')
  assert launches == [0, 0, 2, 2 * env.spec.substeps]
  assert float(s) == float(s_j)
  for f in st._fields:
    assert torch.equal(getattr(st, f), getattr(st_j, f)), f
