"""The fused dream epoch's carried BVAE codes (research/rl/ppo.py
`lenv_rollout` with FBT's `encode_window` and `onestep`), on the CPU.

`lenv_rollout` keeps the window's codes in each window batch under 'z', so
`FBT.onestep` encodes only the frame the window gained. Over 8 steps of a
tiny FBT over a BVAE (4 envs, window 6, ep_len 6: a slide at step 4, the
lockstep timeout at step 6): the codes the FBT reads at positions < i are
the full encode of the window it received, each step writes the frame and
proprio of the full path, and the call returns what a model without the
hook returns. The counters `onestep.frames_encoded` / `.codes_reused` show
one frame encoded a step there, and the whole window on `LearnedEnv.step`.

Marked `cuda` (run on the card alone, in its own process: `python -m
pytest tests/test_torch_lenv_codes.py -m cuda`): the same check at the
dream cell's shape, 128 envs, window 25, FBT 512/8/4, for 101 steps.
"""
import numpy as np
import pytest
import torch

from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.research import utils as rutils
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.rl.main import parse
from boxlcd_tpu_torch.research.rl.ppo import PPO
from boxlcd_tpu_torch.research.wrappers import LearnedEnv, RewardLenv
from boxlcd_tpu_torch.utils import set_tf32

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

STEPS = 8
TINY = dict(args=['--num_envs=4', '--hidden_size=32', '--vel_iters=2',
                  '--pos_iters=1', '--window=6', '--ep_len=6'],
            widths=dict(nfilter=8, vqD=4, vqK=16, n_embed=32, n_head=2,
                        n_layer=1))
# the dream cell's shape (portbench/configs/urchin-fbt.json)
CELL = dict(args=['--num_envs=128', '--hidden_size=256', '--vel_iters=180',
                  '--pos_iters=60', '--window=25', '--ep_len=100'],
            widths=dict(hidden_size=64, nfilter=16, vqD=16, vqK=64,
                        n_embed=512, n_head=8, n_layer=4))


def _dream(tmp_path, monkeypatch, shape, device='cpu'):
  """(a PPO whose env is RewardLenv(LearnedEnv) over an FBT over a BVAE at
  `shape`, the FBT)."""
  monkeypatch.setattr(rutils, 'make_writer',
                      lambda logdir: rutils.NullWriter())
  G = parse(['--env=Urchin', f'--device={device}', *shape['args'],
             f'--logdir={tmp_path}', 'ppo'])
  torch.manual_seed(0)
  ppo = PPO(G)
  raw = ppo.tenv._env
  Gm = type(G)(G)
  Gm.update(shape['widths'])
  model = FBT(raw, Gm, bvae=BVAE(raw, Gm))
  ppo.env = RewardLenv(LearnedEnv(G.num_envs, model, G, real_env=ppo.tenv))
  return ppo, model


def _draws(ppo, model, steps):
  """Every draw of a call, from one generator: pools, normals, uniforms and
  pool indices."""
  pp, gp = ppo.sample_pools()
  g, dev = torch.Generator(device=ppo.device).manual_seed(5), ppo.device
  B, POOL = ppo.G.num_envs, pp['lcd'].shape[0]
  return {'prompt_pool': pp, 'goal_pool': gp,
          'eps': torch.randn((steps, B, ppo.tenv._env.act_size),
                             generator=g, device=dev),
          'u': torch.rand((steps, B, model.z_size), generator=g, device=dev),
          'pidx': torch.randint(0, POOL, (steps, B), generator=g, device=dev),
          'gidx': torch.randint(0, POOL, (steps, B), generator=g,
                                device=dev)}


def _start(ppo, draws):
  """A call's start: prompts from the pool at pointer 1, goals from the
  goal pool."""
  B = ppo.G.num_envs
  wb = ppo._fresh_wb({k: v[:B] for k, v in draws['prompt_pool'].items()})
  goals = {f'goal:{k}': v[B:2 * B] for k, v in draws['goal_pool'].items()}
  return wb, 1, 0, goals


class _Checked:
  """Stands in for a model's `onestep` as the benchmark's recorder does:
  each step, the codes the FBT read against the full encode of the window
  it received, and (with `full`) the frame and proprio written against
  `onestep` on that window with the codes taken out."""

  def __init__(self, model, full=True):
    self.model, self.orig, self.full = model, model.onestep, full
    self.points, self.worst = [], 0.0
    model.onestep = self

  def __call__(self, batch, i, gen, temp=1.0, u=None):
    assert 'z' in batch
    plain = {k: v for k, v in batch.items() if k != 'z'}
    out = self.orig(batch, i, gen, temp, u=u)
    want = self.model.bvae.encode(plain, noise=False)[:, :i]
    got = out['z'][:, :i]
    assert torch.equal(got > 0.5, want > 0.5), i
    self.worst = max(self.worst, float((got - want).abs().max()))
    if self.full:
      ref = self.orig(plain, i, gen, temp, u=u)
      assert set(ref) == set(plain)
      for k in plain:
        assert torch.equal(out[k], ref[k]), (i, k)
    self.points.append(i)
    return out


class _Uncached:
  """A model without the `encode_window` hook: lenv_rollout's path for the
  other video models."""

  def __init__(self, model):
    self.onestep = model.onestep


def _same(a, b):
  """a and b hold equal values, leaf for leaf."""
  if isinstance(a, dict):
    return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
  if isinstance(a, (list, tuple)):
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
  if isinstance(a, torch.Tensor):
    return torch.equal(a, b)
  return bool(np.array_equal(a, b))


def test_carried_codes_are_the_full_encode(tmp_path, monkeypatch):
  """8 steps past a slide and a timeout: each step's codes at positions < i
  are the full encode of its window, its frame and proprio those of the
  full path, and the call returns what the path without codes returns."""
  ppo, model = _dream(tmp_path, monkeypatch, TINY)
  draws = _draws(ppo, model, STEPS)
  start = _start(ppo, draws)
  ppo._lenv_models = [_Uncached(model)]
  want = ppo.lenv_rollout(*start, STEPS, draws)
  ppo._lenv_models = None
  checked = _Checked(model)
  got = ppo.lenv_rollout(*start, STEPS, draws)
  assert checked.points == [1, 2, 3, 4, 4, 4, 1, 2]
  assert set(got[0]) == {'lcd', 'proprio', 'action'}
  assert _same(got, want)
  assert checked.worst < 1e-6


def test_lenv_rollout_encodes_one_frame_a_step(tmp_path, monkeypatch):
  """Over n steps: B frames encoded a step, plus B x W at entry and at the
  timeout; B x (W - 1) codes reused a step."""
  ppo, model = _dream(tmp_path, monkeypatch, TINY)
  draws = _draws(ppo, model, STEPS)
  B, W = ppo.G.num_envs, ppo.G.window
  enc, reused = (trace.counter('onestep.frames_encoded'),
                 trace.counter('onestep.codes_reused'))
  ppo.lenv_rollout(*_start(ppo, draws), STEPS, draws)
  assert trace.counter('onestep.frames_encoded') - enc == \
      B * STEPS + B * W * 2
  assert trace.counter('onestep.codes_reused') - reused == \
      B * (W - 1) * STEPS


def test_learned_env_step_encodes_the_whole_window(tmp_path, monkeypatch):
  """LearnedEnv.step (and through it the unfused PPO path) carries no
  codes: the whole window encoded a step, nothing reused."""
  ppo, _ = _dream(tmp_path, monkeypatch, TINY)
  lenv = ppo.env.lenv
  lenv.reset()
  B, W = lenv.num_envs, lenv.window
  enc, reused = (trace.counter('onestep.frames_encoded'),
                 trace.counter('onestep.codes_reused'))
  for _ in range(3):
    lenv.step(torch.zeros((B, lenv.raw_env.act_size)))
  assert trace.counter('onestep.frames_encoded') - enc == 3 * B * W
  assert trace.counter('onestep.codes_reused') == reused
  assert 'z' not in lenv.window_batch


@pytest.mark.cuda
def test_carried_codes_on_the_card_at_the_cell_shape(tmp_path, monkeypatch):
  """The dream cell's shape on the card, 101 steps past the slides and the
  timeout: each step's codes at positions < i threshold as the full
  encode of its window does."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  set_tf32(False)                       # as the RL entry point runs
  ppo, model = _dream(tmp_path, monkeypatch, CELL, device='cuda')
  steps = 101
  draws = _draws(ppo, model, steps)
  checked = _Checked(model, full=False)
  ppo.lenv_rollout(*_start(ppo, draws), steps, draws)
  assert len(checked.points) == steps
  assert checked.points[-2:] == [23, 1]
  print('largest |carried - full| code:', checked.worst)
  assert checked.worst < 1e-6      # at most the straight-through residue


@pytest.mark.cuda
def test_encode_graph_equals_the_eager_encode(tmp_path, monkeypatch):
  """On the card the one-frame encode replays a CUDA graph: its codes equal
  the eager encode's bit for bit, from a strided slice of a window too, and
  a change of a BVAE parameter captures it again."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  set_tf32(False)
  ppo, model = _dream(tmp_path, monkeypatch, CELL, device='cuda')
  pool = _draws(ppo, model, 1)['prompt_pool']
  B, W = ppo.G.num_envs, ppo.G.window
  rows = torch.randperm(B * W, device='cuda') % pool['lcd'].shape[0]
  wb = {k: v[rows].reshape(B, W, *v.shape[1:]) for k, v in pool.items()}

  def eager(i):
    return model.bvae.encode({k: v[:, i].contiguous() for k, v in wb.items()},
                             noise=False)
  for i in (3, 7, 3):
    got = model._encode_frames(wb['lcd'][:, i], wb['proprio'][:, i])
    assert torch.equal(got, eager(i)), i
  assert len(model._graphs) == 1
  before = eager(3)
  with torch.no_grad():
    for p in model.bvae.module.parameters():
      p.mul_(1.5)
  got = model._encode_frames(wb['lcd'][:, 3], wb['proprio'][:, 3])
  assert torch.equal(got, eager(3)) and not torch.equal(got, before)
  assert len(model._graphs) == 1
