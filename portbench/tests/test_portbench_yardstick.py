"""The frozen arithmetic against the port's measurement scripts it was
copied from, and the per-layer readers' and the window's arithmetic."""
import json
from pathlib import Path

import pytest
import torch

from portbench import yardstick
from portbench.metrics import _read
from portbench.reference.env import World

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / 'portbench/configs/urchin.json').read_text())


def worlds(vi, pi):
  import boxlcd_tpu_torch
  G = dict(CFG['env_config'], vel_iters=vi, pos_iters=pi)
  ours = World(dict(CFG, env_config=G))
  port = boxlcd_tpu_torch.env_map['Urchin'](G, device='cpu')
  return ours, port


@pytest.mark.parametrize('iters', [(8, 4), (180, 60)])
def test_frozen_counts_equal_roofline(iters):
  from boxlcd_tpu_torch.envs.env import Env
  from boxlcd_tpu_torch.research.scripts import roofline
  ours, port = worlds(*iters)
  st = Env.reset(port, torch.Generator().manual_seed(0), 16)
  for c in (0.0, 1.5, 4.0):
    assert yardstick.mega_flops_per_substep(ours.spec, c) == \
        roofline.mega_flops_per_substep(port.spec, c)
  assert yardstick.state_bytes(st) == roofline.state_bytes(st)
  for B, T in ((4000, 100), (4096, 100), (7, 3)):
    assert yardstick.mega_bytes(ours.spec, st, B, T) == \
        roofline.mega_bytes(port.spec, st, B, T)
    assert yardstick.mega_bound(ours.spec, st, B, T) == \
        roofline.mega_bound(port.spec, st, B, T)


def test_urchin_counts_by_hand():
  """One substep at 8/4 with 2 contact points: 4 bodies (a circle and 3
  boxes), 4 walls, no pairs, 3 joints, 3 label rounds."""
  ours, _ = worlds(8, 4)
  V = 3 * 4
  want = ((7 + 3 * (7 + 14 * 4)) + 4 * (12 + 3 * (5 * 4 + 12))
          + 2 * (45 + 45 * 8 + 35) + 3 * (60 + 87 * 8 + 55)
          + 10 * 4 + 2 * 3 * 3)
  assert V == 12
  assert yardstick.mega_flops_per_substep(ours.spec, 2.0) == want


def test_traj_bound_equals_chip_smoke():
  """traj_bound and raster_flops equal chip_smoke.py's on Urchin."""
  import chip_smoke
  from boxlcd_tpu_torch.render import traj_raster
  ours, port = worlds(8, 4)
  ic = torch.zeros((64, port.spec.n), dtype=torch.bool)
  ic[:, 0] = True
  tables = traj_raster.make_traj_render(port.spec, 32, 16).consts.tables(
      'cpu')
  assert tables
  assert yardstick.raster_flops(ours.spec, ic, 16) == \
      chip_smoke.raster_flops(port.spec, ic, 16)
  assert yardstick.traj_bound(ours.spec, ic, 100, 16, tables) == \
      chip_smoke.traj_bound(port.spec, ic, 100, 16, tables)


def test_readers_arithmetic():
  ours, _ = worlds(180, 60)
  st = ours.reset_from_uniforms(torch.rand((8, ours.spec.n, 4)))
  yard = {'spec': ours.spec, 'final': st, 'B': 8, 'T': 5,
          'is_circle': st.is_circle, 'lcd_h': 16, 'raster_tables': {}}
  rec = {'window_s': 2.0, 'busy_s': 1.5, 'steps': 1000,
         'spans': {'copy_s': [0.01, 0.03], 'encode_s': [0.1, 0.1]},
         'stages_ms': {'dispatch': 10.0, 'megakernel': 6.0,
                       'traj_raster': 1.0},
         'yard': yard}
  assert _read.idle_pct(rec) == pytest.approx(25.0)
  assert _read.glue_ms(rec) == pytest.approx(3.0)
  assert _read.host_ms(rec) == pytest.approx(120.0)
  bound, _, _ = yardstick.mega_bound(ours.spec, st, 8, 5)
  assert _read.mega_roofline(rec) == pytest.approx(100 * bound / 6.0)
  per = (yardstick.mega_flops(ours.spec, st, 8, 5)
         + 5 * yardstick.raster_flops(ours.spec, st.is_circle, 16)) / 40
  assert _read.mfu(rec) == pytest.approx(100 * per * 1000 / 2.0 / 67e12)
  empty = {'spans': {}, 'stages_ms': {}}
  for reader in (_read.idle_pct, _read.glue_ms, _read.host_ms,
                 _read.mega_roofline, _read.traj_raster_roofline, _read.mfu):
    assert reader(empty) is None


def test_window_rate_arithmetic(monkeypatch):
  """The window counts whole dispatches, the env-steps of the episodes that
  passed the tripwire, and its own length."""
  from portbench.drivers import mega_rollout
  clock = iter(range(1000))
  monkeypatch.setattr(mega_rollout.time, 'perf_counter',
                      lambda: float(next(clock)))
  cell = mega_rollout.Cell.__new__(mega_rollout.Cell)
  cell.K, cell.B, cell.T = 2, 10, 5
  cell.device = torch.device('cpu')
  cell.spans = {'dispatch_s': []}
  calls = []

  def group(timed):
    calls.append(timed)
    return cell.K * cell.B, (cell.B if len(calls) == 2 else 0)
  cell._group = group
  episodes, failed, steps, wall = cell.window(3.5)
  # t0 = 0; each group reads the clock at its start, end and the check
  assert cell.dispatches == 2 * cell.K and len(calls) == 2
  assert episodes == 40 and failed == 10
  assert steps == (40 - 10) * 5
  assert wall == pytest.approx(7.0)


def test_device_activity_union():
  from portbench import trace
  events = [('a', 0.0, 10.0), ('b', 5.0, 12.0), ('a', 20.0, 25.0),
            ('c', 30.0, 31.0)]
  busy, by, gaps = trace.activity(events)
  assert busy == pytest.approx(18e-6)
  assert by['a'] == (pytest.approx(15e-6), 2)
  assert gaps == [(12.0, 20.0), (25.0, 30.0)]
  assert trace.top_ops(by, 2)[0][0].startswith('a (x2)')
  assert trace.activity([]) == (0.0, {}, [])


def test_dream_flops_from_shapes_equal_a_counted_step():
  """dream_step_flops at a tiny size equals torch's own count of the
  multiply-adds of the reference's step: the window encoded, the FBT, one
  decode, the actor and the critic."""
  from torch.utils.flop_counter import FlopCounterMode
  from portbench.reference import dream as ref
  s = {'B': 3, 'W': 5, 'H': 16, 'Wd': 32, 'P': 6, 'A': 3, 'hidden': 8,
       'nfilter': 4, 'vqD': 2, 'zH': 4, 'zW': 8, 'n_embed': 16,
       'n_layer': 2, 'n_head': 2, 'ppo_hidden': 12}
  Z = s['zH'] * s['zW'] * s['vqD']
  g = torch.Generator().manual_seed(0)
  r = lambda *shape: torch.randn(shape, generator=g)
  nf, n, E = s['nfilter'], s['hidden'], s['n_embed']

  def lin(name, i, o, bias=True):
    p = {f'{name}.weight': r(o, i)}
    if bias:
      p[f'{name}.bias'] = r(o)
    return p

  def cv(name, i, o, k):
    return {f'{name}.weight': r(o, i, k, k), f'{name}.bias': r(o)}

  def rb(name):
    return {**cv(f'{name}.Conv_0', nf, nf, 3), **cv(f'{name}.Conv_1', nf, nf, 3),
            **lin(f'{name}.Dense_0', n, nf),
            **{f'{name}.GroupNorm_{j}.{w}': r(nf) for j in (0, 1)
               for w in ('weight', 'bias')}}
  pb = {**lin('encoder.Dense_0', s['P'], n), **lin('encoder.Dense_1', n, n),
        **lin('encoder.Dense_2', n, n), **cv('encoder.Conv_0', 1, nf, 3),
        **rb('encoder.ResBlock_0'), **cv('encoder.Conv_1', nf, nf, 3),
        **rb('encoder.ResBlock_1'), **cv('encoder.Conv_2', nf, nf, 3),
        **rb('encoder.ResBlock_2'), **cv('encoder.Conv_3', nf, s['vqD'], 1),
        **lin('decoder.Dense_0', Z, n), **lin('decoder.Dense_1', n, n),
        **lin('decoder.Dense_2', n, s['P']),
        **cv('decoder.Upsample_0.Conv_0', s['vqD'], nf, 3),
        **cv('decoder.Upsample_1.Conv_0', nf, nf, 3),
        **cv('decoder.Conv_0', nf, nf, 3), **cv('decoder.Conv_1', nf, 1, 3)}
  pf = {**lin('embed', Z, E // 2, False), **lin('cond_in', 3, E // 2, False),
        'pos_emb': r(1, s['W'], E), **lin('dist_head.Dense_0', E, Z),
        'ln_f.weight': r(E), 'ln_f.bias': r(E)}
  for i in range(s['n_layer']):
    b = f'block{i}'
    pf.update({**lin(f'{b}.attn.qkv', E, 3 * E), **lin(f'{b}.attn.proj', E, E),
               **lin(f'{b}.Dense_0', E, 4 * E), **lin(f'{b}.Dense_1', 4 * E, E),
               **{f'{b}.ln{j}.{w}': r(E) for j in (1, 2)
                  for w in ('weight', 'bias')}})
  P, h = s['P'], s['ppo_hidden']
  pa = {'pi.log_std': r(3)}
  for head, out in (('pi', 3), ('v', 1)):
    pa.update({**lin(f'{head}.goal_preproc', P, P),
               **lin(f'{head}.BaseMLP_0.Dense_0', 2 * P, h),
               **lin(f'{head}.BaseMLP_0.Dense_1', h, h),
               **lin(f'{head}.BaseMLP_0.Dense_2', h, out)})
  B, W = s['B'], s['W']
  lcd = (torch.rand((B, W, 16, 32), generator=g) < 0.5).float()
  with FlopCounterMode(display=False) as fc:
    ref.onestep(pb, pf, lcd, r(B, W, P), r(B, W, 3), 2, torch.rand(B, Z),
                1.0, s)
    ref.policy(pa, r(B, P), r(B, P))
  assert fc.get_total_flops() == yardstick.dream_step_flops(s)
