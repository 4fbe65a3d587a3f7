"""The DeepSeek-V2 world model (`nets/dsv2.py`, `FBTDSV2`) against its plain
reference (`nets/reference/dsv2_ref.py`), and its grouped-expert kernel
(`nets/moe_kernel.py`).

On the CPU, at a small size (hidden 64, 4 heads, kv_lora 16, nope/rope/v
8/4/8, 8 experts, top-2, 1 shared, 1 dense + 2 MoE layers, window 6): logits
against the reference on seeded weights, the router, the YaRN table at the
published settings, MLA's core against SDPA, the MoE layer's expert range
split in two halves, the kernel's plain version (its tile table) against the
layer's loop, the tile table at ragged counts, `onestep` with carried codes
against the full window, `sample` without the float64 copy, the spans and
counters, the reference's imports.

Marked `cuda` (run on the card: `python -m pytest tests/test_torch_dsv2.py
-m cuda`): the expert kernels against per-expert bfloat16 `torch.mm` at the
published widths under skewed and ragged routing and over a held range of
experts, and captured in a CUDA graph replayed with other routings; the MoE
layer and a whole `onestep`
at the dream cell's shape (128 envs, window 25, DeepSeek-V2-Lite) with no
host synchronisation; `onestep`'s logits there against the float32
reference within the cell's limits (portbench/limits/).
"""
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from boxlcd_tpu_torch import trace
from boxlcd_tpu_torch.research import utils as rutils
from boxlcd_tpu_torch.research.nets import dsv2, moe_kernel
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.reference import dsv2_ref as ref
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.nets.video_models.fbt_dsv2 import FBTDSV2
from boxlcd_tpu_torch.research.rl.main import parse

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=16,
             qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
CFG = dsv2.config(SMALL)
Z, A, T = 32, 3, 6


def _module(dtype=torch.float32, cfg=CFG, seed=0, device='cpu', **kw):
  torch.manual_seed(seed)
  prev = torch.get_default_dtype()
  torch.set_default_dtype(dtype)
  try:
    with torch.device(device):
      m = dsv2.DSV2Module(cfg, T, Z, A, **kw)
  finally:
    torch.set_default_dtype(prev)
  with torch.no_grad():   # norms away from 1, so their scales are tested
    for name, p in m.named_parameters():
      if p.dim() == 1:
        p.add_(0.1 * torch.randn_like(p))
  return m


def _inputs(B=3, seed=1):
  g = torch.Generator().manual_seed(seed)
  z = (torch.rand((B, T, Z), generator=g) > 0.5).float()
  a = torch.rand((B, T, A), generator=g) * 2 - 1
  return z, a


def test_parameters_are_the_references():
  sd = _module().state_dict()
  assert {k: tuple(v.shape) for k, v in sd.items()} == \
      ref.param_shapes(CFG, Z, A)
  assert list(sd) == list(ref.param_shapes(CFG, Z, A))


def test_logits_equal_the_reference():
  """float32: 2e-5 absolute (logits ~1; the same products summed in
  another order, the experts' rows through index_add). bfloat16 against
  the float32 reference: the median |gap| within 0.02 (every matmul input
  and the residual rounded to 8 bits, ~4e-3 relative a rounding, over 3
  layers: 5.5e-3 read); a token that the rounding routes to another expert
  at a near tie of the top-2 of 8 moves its logits by ~0.1-0.3, which sets
  the tail, so not a high percentile."""
  z, a = _inputs()
  m = _module()
  with torch.no_grad():
    got = m(z, a)
  want = ref.logits(m.state_dict(), z, a, CFG)
  assert got.dtype == torch.float32
  assert (got - want).abs().max() <= 2e-5
  mb = _module(torch.bfloat16)
  with torch.no_grad():
    got = mb(z, a)
  want = ref.logits(mb.state_dict(), z, a, CFG)
  assert got.dtype == torch.float32
  assert (got - want).abs().median() <= 0.02


def test_router_takes_top_k_unnormalised_and_ties_as_the_reference():
  m = _module()
  moe = m.layers[1].mlp
  x = torch.randn(40, 64)
  with torch.no_grad():
    moe.gate.weight[3] = moe.gate.weight[5]       # ties between 3 and 5
    moe.gate.weight[6] = moe.gate.weight[5]
    w, idx = moe.route(x)
  rw, ridx = ref.route(m.state_dict(), 'layers.1.mlp', x, CFG)
  assert torch.equal(idx, ridx) and torch.allclose(w, rw, atol=1e-7)
  scores = torch.softmax(x @ moe.gate.weight.T, -1)
  assert torch.allclose(w, scores.gather(1, idx), atol=1e-7)
  assert (w.sum(-1) < 1 - 1e-3).all()       # not renormalised
  top = torch.topk(scores, 2, -1).values
  assert torch.allclose(w.sort(-1, descending=True).values, top, atol=1e-7)


def test_yarn_at_the_published_settings():
  lite = dsv2.config()
  assert dsv2.yarn_correction_range(lite) == (10, 23)
  m = 0.1 * 0.707 * math.log(40) + 1
  assert abs(m - 1.2608) < 1e-4
  assert abs(dsv2.softmax_scale(lite) - 192 ** -0.5 * m * m) < 1e-12
  assert abs(dsv2.softmax_scale(lite) - 0.11472) < 1e-5
  cos, sin = dsv2.rope_tables(lite, 25)
  rcos, rsin = ref.rope_tables(lite, 25)
  # float32 angles against float64 ones, up to 24 radians: 2e-6
  assert (cos - rcos).abs().max() <= 2e-6 and (sin - rsin).abs().max() <= 2e-6
  # position 1's angles are the inverse frequencies: extrapolated below
  # the ramp, divided by the factor above it
  inv = torch.atan2(sin[1, :32], cos[1, :32]).double()
  base = 1e4 ** (-torch.arange(0, 64, 2).double() / 64)
  assert torch.allclose(inv[:10], base[:10], rtol=1e-5)
  assert torch.allclose(inv[23:], base[23:] / 40, rtol=1e-5)
  assert ((inv[10:23] < base[10:23]) & (inv[10:23] > base[10:23] / 40)).all()


def test_mla_core_is_causal_attention_over_the_rotated_keys():
  """MLA's core (`dsv2.attend`, plain torch on the card as on the CPU)
  against scaled_dot_product_attention over q and k rotated by `rotate`,
  the one k_pe broadcast to every head, in float32: the same function,
  summed in another order (1e-5 is ~50 float32 roundings of values ~1)."""
  torch.manual_seed(4)
  B, nh, dn, dr, dv = 2, 4, 8, 4, 8
  q = torch.randn(B, T, nh, dn + dr)
  kv = torch.randn(B, T, nh, dn + dv)
  k_pe = torch.randn(B, T, dr)
  cis = dsv2.rope_cis(CFG, T)
  bias = torch.full((T, T), float('-inf')).triu(1)
  scale = dsv2.softmax_scale(CFG)
  got = dsv2.attend(q, kv, k_pe, cis, bias, scale)
  qr = torch.cat([q[..., :dn], dsv2.rotate(q[..., dn:], cis)], -1)
  kr = torch.cat([kv[..., :dn], dsv2.rotate(k_pe, cis)[:, :, None]
                  .expand(B, T, nh, dr)], -1)
  want = torch.nn.functional.scaled_dot_product_attention(
      qr.transpose(1, 2), kr.transpose(1, 2), kv[..., dn:].transpose(1, 2),
      is_causal=True, scale=scale)
  assert torch.allclose(got, want.transpose(1, 2).reshape(B, T, nh * dv),
                        atol=1e-5)


def test_expert_range_halves_add_up_to_the_layer():
  """Two layers holding experts 0-3 and 4-7 of one layer's weights: the
  halves' routed parts and the shared expert, counted once, add up to the
  whole layer, in the port (its loop and the kernel's plain version) and
  in the reference."""
  full = _module().layers[1].mlp
  sd = {k: v for k, v in full.state_dict().items()}
  halves = []
  for lo, hi in ((0, 4), (4, 8)):
    h = dsv2.MoE(CFG, held=(lo, hi))
    part = dict(sd)
    for k in ('gate_proj', 'up_proj', 'down_proj'):
      part[f'experts.{k}'] = sd[f'experts.{k}'][lo:hi]
    h.load_state_dict(part)
    halves.append(h)
  x = torch.randn(50, 64)
  p = {f'm.{k}': v for k, v in sd.items()}
  with torch.no_grad():
    whole = full(x)
    w, idx = full.route(x)
    a = halves[0](x)                                   # with the shared
    wb, ib = halves[1].route(x)
    b = halves[1].routed_plain(x, wb, ib)              # without
    e = halves[1].experts
    kb, _ = moe_kernel.moe_experts_plain(x, wb, ib, e.gate_proj, e.up_proj,
                                         e.down_proj)
  assert torch.allclose(a + b, whole, atol=2e-6)
  assert torch.allclose(kb, b, atol=2e-6)
  ra = ref.moe({**p, **{f'm.experts.{k}': sd[f'experts.{k}'][:4] for k in
                        ('gate_proj', 'up_proj', 'down_proj')}},
               'm', x, CFG, held=(0, 4))
  rb = ref.moe({**p, **{f'm.experts.{k}': sd[f'experts.{k}'][4:] for k in
                        ('gate_proj', 'up_proj', 'down_proj')}},
               'm', x, CFG, held=(4, 8), shared=False)
  assert torch.allclose(ra + rb, ref.moe(p, 'm', x, CFG), atol=2e-6)
  assert torch.allclose(ra + rb, whole, atol=2e-6)


def test_kernel_plan_covers_skewed_routing():
  """The kernel's plain version (its plan and tile table) equals the
  layer's loop where one expert takes more rows than two tiles, some
  none, and the range is part of the experts."""
  m = dsv2.MoE(dict(CFG, n_routed_experts=8))
  N, k = 300, 2
  g = torch.Generator().manual_seed(3)
  idx = torch.stack([torch.zeros(N, dtype=torch.long),
                     1 + torch.randint(0, 4, (N,), generator=g)], 1)
  idx[::7, 1] = 7                                       # 6: no rows
  w = torch.rand((N, k), generator=g)
  x = torch.randn((N, 64), generator=g)
  order, counts = moe_kernel.plan(idx, 8)
  assert counts.tolist()[0] == N and counts.tolist()[6] == 0
  assert torch.equal(idx.reshape(-1)[order].sort().values,
                     idx.reshape(-1)[order])         # sorted by expert
  tile_end, first, width = moe_kernel.tile_table(counts)
  assert width.tolist()[0] == 104            # 300 rows: 3 tiles of 104
  assert tile_end.tolist()[0] == 3 and first.tolist()[1] == N
  assert tile_end[-1] <= moe_kernel.max_row_tiles(N * k, 8)
  e = m.experts
  for held in ((0, 8), (2, 7)):
    mm = dsv2.MoE(dict(CFG, n_routed_experts=8), held=held)
    with torch.no_grad():
      for name in ('gate_proj', 'up_proj', 'down_proj'):
        getattr(mm.experts, name).copy_(getattr(e, name)[held[0]:held[1]])
      wl, il = mm.held_routes(w, idx)
      want = mm.routed_plain(x, wl, il)
    mine = (idx >= held[0]) & (idx < held[1])
    assert torch.equal(wl != 0, mine) and torch.equal(il[mine],
                                                      idx[mine] - held[0])
    ee = mm.experts
    got, cnt = moe_kernel.moe_experts_plain(
        x, wl, il, ee.gate_proj, ee.up_proj, ee.down_proj)
    assert torch.allclose(got, want, atol=2e-6)
    assert cnt.sum() == idx.numel() and torch.equal(cnt, mm.counts)


RAGGED = [0, 1, 7, 8, 9, 63, 64, 65, 127, 128, 129, 255, 256, 257, 300,
          1100]


@pytest.mark.parametrize('counts', [
    RAGGED, RAGGED[::-1], [0] * 5 + [19200] + [0] * 2, [0, 0, 0],
    [300 + e % 7 for e in range(64)]],
    ids=['ragged', 'ragged-reversed', 'one-expert', 'none', 'lite'])
def test_tile_table_covers_each_slot_once(counts):
  """The kernels' tile list (`tile_table`) at ragged counts: each expert's
  token tiles hold its rows once each, in order, at most TN a tile, all
  but the last of the width; `rows_tiled` is the sum of the tiles' rows
  rounded up to 8 (wgmma's N); `max_row_tiles` bounds the tiles; the plain
  version's loop visits the same tiles."""
  c = torch.tensor(counts, dtype=torch.int32)
  ends, first, width = (t.tolist() for t in moe_kernel.tile_table(c))
  tiles, covered, start = [], 0, 0
  for e, n in enumerate(counts):
    nt = ends[e] - start
    start = ends[e]
    assert first[e] == sum(counts[:e])
    rows = [min(width[e], n - j * width[e]) for j in range(nt)]
    assert all(0 < r <= moe_kernel.TN for r in rows)
    assert sum(rows) == n and (nt == 0) == (n == 0)
    assert all(r == width[e] for r in rows[:-1]) and width[e] % 8 == 0
    if n:
      assert nt <= -(-n // moe_kernel.TN)    # no more tiles than TN needs
    tiles += [(e, j) for j in range(nt)]
    covered += sum(-(-r // 8) * 8 for r in rows)   # wgmma's N a tile
  assert int(moe_kernel.rows_tiled(c)) == covered
  assert moe_kernel.rows_tiled(torch.stack([c, c])).tolist() == [covered] * 2
  assert len(tiles) <= moe_kernel.max_row_tiles(sum(counts), len(counts))
  if counts == RAGGED:       # by hand: 2,769 rows in 2,816 (129: 72 + 64;
    assert covered == 2816   # 257: 3 x 88; 1,100: 8 x 128 + 80)
  if not covered:           # no slots: no rows for the plain version
    return
  # the plain version visits each tile once: route each expert's rows to
  # it and count the rows its loop multiplies by the gate and up weights
  idx = torch.repeat_interleave(torch.arange(len(counts)), c)[:, None]
  seen = []
  real_mm = torch.Tensor.__matmul__

  def count_rows(a, b):
    if a.shape[-1] == 4 and b.shape[0] == 4:       # the gate product
      seen.append(a.shape[0])
    return real_mm(a, b)
  E = len(counts)
  wg = torch.zeros((E, 2, 4))
  wd = torch.zeros((E, 4, 2))
  x = torch.zeros((int(c.sum()), 4))
  w = torch.ones_like(idx, dtype=torch.float32)
  try:
    torch.Tensor.__matmul__ = count_rows
    moe_kernel.moe_experts_plain(x, w, idx, wg, wg, wd)
  finally:
    torch.Tensor.__matmul__ = real_mm
  want = [min(width[e], counts[e] - j * width[e]) for e, j in tiles]
  assert sorted(seen) == sorted(want * 2)     # gate and up, a tile each


def _fbt(tmp_path, monkeypatch, args, widths, dsv2_cfg, precision,
         device='cpu'):
  monkeypatch.setattr(rutils, 'make_writer',
                      lambda logdir: rutils.NullWriter())
  G = parse(['--env=Urchin', f'--device={device}', *args,
             f'--logdir={tmp_path}', 'ppo'])
  from boxlcd_tpu_torch.research.rl.ppo import PPO
  ppo = PPO(G)
  raw = ppo.tenv._env
  Gm = type(G)(G)
  Gm.update(widths, dsv2=dsv2_cfg, dsv2_precision=precision)
  torch.manual_seed(0)
  return FBTDSV2(raw, Gm, bvae=BVAE(raw, Gm))


TINY = dict(args=['--num_envs=4', '--hidden_size=32', '--vel_iters=2',
                  '--pos_iters=1', '--window=6', '--ep_len=6'],
            widths=dict(nfilter=8, vqD=4, vqK=16))


def _window(model, B, seed=2):
  g = torch.Generator().manual_seed(seed)
  env, W = model.env, model.block_size
  dev = model.device
  return {'lcd': (torch.rand((B, W, env.lcd_h, env.lcd_w), generator=g)
                  > 0.5).float().to(dev),
          'proprio': (torch.rand((B, W, model.proprio_n), generator=g)
                      * 2 - 1).to(dev),
          'action': (torch.rand((B, W, model.act_n), generator=g)
                     * 2 - 1).to(dev)}


def test_onestep_with_carried_codes_equals_the_full_window(tmp_path,
                                                           monkeypatch):
  model = _fbt(tmp_path, monkeypatch, TINY['args'], TINY['widths'], SMALL,
               'float32')
  wb = _window(model, 4)
  i = 4
  codes = model.encode_window(wb)
  codes[:, i - 1] = 0.0                 # stale: onestep re-encodes i - 1
  u = torch.rand((4, model.z_size), generator=torch.Generator().manual_seed(7))
  full = model.onestep(dict(wb), i, None, u=u)
  carried = model.onestep(dict(wb, z=codes), i, None, u=u)
  for k in ('lcd', 'proprio'):
    assert torch.equal(full[k], carried[k])
  assert torch.equal(carried['z'], model.encode_window(wb))


def test_sample_serves_without_a_float64_copy(tmp_path, monkeypatch):
  model = _fbt(tmp_path, monkeypatch, TINY['args'], TINY['widths'], SMALL,
               'bfloat16')

  def refuse(self):
    raise AssertionError('sample made the float64 copy')
  monkeypatch.setattr(FBT, 'serving_net', refuse)
  g = torch.Generator().manual_seed(3)
  act = torch.rand((2, 6, model.act_n), generator=g) * 2 - 1
  u = torch.rand((6, 2, model.z_size), generator=g)
  a = model.sample(None, 2, action=act, u=u, use_cache=True)
  b = model.sample(None, 2, action=act, u=u, use_cache=False)
  assert model._net64 is None
  assert all(p.dtype == torch.bfloat16 for p in model.module.parameters())
  for k in ('lcd', 'proprio'):
    assert torch.equal(a[k], b[k])


def test_loss_trains_at_a_small_size(tmp_path, monkeypatch):
  model = _fbt(tmp_path, monkeypatch, TINY['args'], TINY['widths'], SMALL,
               'float32')
  batch = _window(model, 4)
  m = model.update(batch, model.gen)
  assert torch.isfinite(m['loss/total']) and torch.isfinite(m['grad_norm'])
  grads = [p.grad for p in model.module.layers[1].mlp.experts.parameters()]
  assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_spans_and_counters():
  m = _module()
  z, a = _inputs(B=2)
  trace.start()
  try:
    with torch.no_grad():
      m(z, a)
  finally:
    rec = trace.stop()
  names = [s['name'] for s in rec['spans']]
  assert names.count('dsv2.attn') == 3 and names.count('dsv2.moe') == 2
  assert names.count('dsv2.mlp') == 1
  c = rec['counters']
  assert c['moe.tokens_routed'] == 2 * 2 * T * 2      # layers x tokens x k
  assert 0 < c['moe.tokens_busiest'] <= 2 * 2 * T
  # 12 tokens a call, top-2: an expert's rows fit one tile, rounded up to 8
  routed = [b.mlp.counts for b in m.layers if b.moe]
  assert c['moe.rows_tiled'] == sum(int(((r + 7) // 8 * 8).sum())
                                    for r in routed)
  with torch.no_grad():                               # off: no counting
    m(z, a)
  assert trace.stop()['counters'] == {}


@pytest.mark.parametrize('path', [
    'boxlcd_tpu_torch/research/nets/reference/dsv2_ref.py',
    'portbench/reference/dsv2.py'])
def test_reference_imports_only_torch(path):
  tree = ast.parse((ROOT / path).read_text())
  mods = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      mods |= {a.name.split('.')[0] for a in node.names}
    elif isinstance(node, ast.ImportFrom):
      mods.add((node.module or '').split('.')[0])
  assert mods <= {'__future__', 'contextlib', 'math', 'torch'}, mods


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  return torch.device('cuda')


def _skewed(N, E, k, device, seed=0):
  """Expert ids (N, k), distinct in a row: expert 0 in the first 1,100
  rows, the rest drawn with weights falling as 1/(e+1), experts E-4..E-1
  never; router weights (N, k) float32."""
  g = torch.Generator(device='cpu').manual_seed(seed)
  p = 1.0 / torch.arange(1, E + 1, dtype=torch.float64)
  p[-4:] = 0
  p[0] = 0
  idx = torch.multinomial(p.expand(N, E), k, generator=g)
  idx[:1100, 0] = 0
  w = torch.rand((N, k), generator=g) / k
  return idx.to(device), w.to(device)


def _ragged(N, E, k, device, seed=0):
  """Expert ids (N, k), distinct in a row, whose counts include 0, 1, 7,
  8, 9, 63, 64, 65, 255, 256, 257 and 1,100 rows, the other experts
  sharing the rest about evenly; router weights (N, k) float32."""
  special = [0, 1, 7, 8, 9, 63, 64, 65, 255, 256, 257, 1100]
  rest = N * k - sum(special)
  n = E - len(special)
  counts = special + [rest // n + (e < rest % n) for e in range(n)]
  g = torch.Generator(device='cpu').manual_seed(seed)
  perm = torch.randperm(E, generator=g)
  # each expert's slots dealt to consecutive tokens: distinct in a row
  flat = torch.repeat_interleave(perm, torch.tensor(counts))
  idx = flat.view(k, N).T.contiguous()
  w = torch.rand((N, k), generator=g) / k
  return idx.to(device), w.to(device)


def _experts(dev, E, H=2048, I=1408, seed=1):
  """x (3,200, H), the experts' bfloat16 weights (N(0, 1/fan_in)), shared
  and residual rows, drawn on the card."""
  g = torch.Generator(device=dev).manual_seed(seed)
  x = torch.randn((3200, H), generator=g, device=dev).bfloat16()
  wg, wu = (torch.randn((E, I, H), generator=g, device=dev) / H ** .5
            for _ in range(2))
  wd = torch.randn((E, H, I), generator=g, device=dev) / I ** .5
  shared = torch.randn((3200, H), generator=g, device=dev).bfloat16()
  res = torch.randn((3200, H), generator=g, device=dev).bfloat16()
  return x, wg.bfloat16(), wu.bfloat16(), wd.bfloat16(), shared, res


@pytest.mark.cuda
@pytest.mark.parametrize('routing', ['skewed', 'ragged', 'held'])
def test_expert_kernel_against_torch_mm(cuda_device, routing):
  """At DeepSeek-V2-Lite's widths (3,200 tokens, 64 experts, top-6,
  hidden 2048, expert width 1408), the shared experts' output and the
  residual added, under three routings: an expert of 1,100 rows and four
  of none (skewed); counts of 0, 1, 7, 8, 9, 63, 64, 65, 255, 256, 257 and
  1,100 rows, each side of the tile widths (ragged); a layer holding 40 of
  the 64 experts, routes to the others weighing 0 (held). The kernel
  against per-expert bfloat16 torch.mm, both against float32. The kernel
  rounds less (float32 gate and up), so its mean error is at most
  torch.mm's; both round each output to bfloat16 at the end, so the
  largest error of either is about one rounding of the largest output
  (0.0161 against torch.mm's 0.0160 read on an H100): within a quarter
  more than torch.mm's. Its plain version sums each dot product
  in another order in float32, so h and y can round to neighbouring
  bfloat16 values; such a step in a y of the largest size, times its
  router weight, reaches a few percent of the output's rms (0.039 read
  without the shared experts): within 2^-7 of the value plus 2^-4 of the
  rms everywhere, 2^-8 of the rms on average."""
  dev = cuda_device
  N, E, k = 3200, 64, 6
  x, wg, wu, wd, shared, res = _experts(dev, E)
  if routing == 'ragged':
    idx, w = _ragged(N, E, k, dev)
  else:
    idx, w = _skewed(N, E, k, dev)
  if routing == 'held':
    lo, hi = 12, 52
    mine = (idx >= lo) & (idx < hi)
    w, idx = torch.where(mine, w, 0.0), (idx - lo).clamp(0, hi - lo - 1)
    wg, wu, wd = wg[lo:hi], wu[lo:hi], wd[lo:hi]
    E = hi - lo
  got, counts = moe_kernel.moe_experts(x, w, idx, wg, wu, wd, shared, res)
  torch.cuda.synchronize()
  plain, _ = moe_kernel.moe_experts_plain(x, w, idx, wg, wu, wd, shared, res)
  f32 = torch.zeros((N, x.shape[1]), device=dev)
  mm = torch.zeros((N, x.shape[1]), device=dev)
  for e in range(E):
    tok, slot = (idx == e).nonzero(as_tuple=True)
    assert counts[e] == tok.numel()
    if not tok.numel():
      continue
    xe = x[tok]
    ye = torch.mm(torch.nn.functional.silu(torch.mm(xe, wg[e].T)) *
                  torch.mm(xe, wu[e].T), wd[e].T)
    mm.index_add_(0, tok, ye.float() * w[tok, slot, None])
    xf = xe.float()
    yf = (torch.nn.functional.silu(xf @ wg[e].float().T) *
          (xf @ wu[e].float().T)) @ wd[e].float().T
    f32.index_add_(0, tok, yf * w[tok, slot, None])
  if routing == 'ragged':
    assert {0, 1, 7, 8, 9, 63, 64, 65, 255, 256, 257, 1100} <= \
        set(counts.tolist())
  mm = (mm.bfloat16().float() + shared.float()).bfloat16().float()
  mm = (res.float() + mm).bfloat16().float()
  f32 = f32 + shared.float() + res.float()
  err_k = (got.float() - f32).abs()
  err_mm = (mm - f32).abs()
  assert err_k.mean() <= err_mm.mean() and err_k.max() <= 1.25 * err_mm.max()
  d = (got.float() - plain.float()).abs()
  rms = plain.float().pow(2).mean().sqrt()
  assert (d <= 2 ** -7 * plain.float().abs() + 2 ** -4 * rms).all()
  assert d.mean() <= 2 ** -8 * rms
  assert counts.sum() == idx.numel()


@pytest.mark.cuda
def test_expert_kernel_replays_in_a_graph_with_new_routing(cuda_device):
  """The kernels captured in a CUDA graph (their tensor maps hold the
  graph pool's h and the weights; the tile list comes from the counts on
  the device) and replayed with other routings written into the same
  input buffers: each replay equals the eager call on its routing, bit
  for bit (each output is summed in one fixed order)."""
  dev = cuda_device
  N, E, k = 3200, 64, 6
  x, wg, wu, wd, shared, res = _experts(dev, E)
  routings = [_skewed(N, E, k, dev), _ragged(N, E, k, dev),
              _skewed(N, E, k, dev, seed=5), _ragged(N, E, k, dev, seed=6)]
  idx, w = (t.clone() for t in routings[0])
  counts = torch.zeros(E, dtype=torch.int32, device=dev)

  def call():
    return moe_kernel.moe_experts(x, w, idx, wg, wu, wd, shared, res,
                                  counts)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    call()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out, _ = call()
  for ri, rw in routings[1:] + routings[:1]:
    idx.copy_(ri)
    w.copy_(rw)
    graph.replay()
    torch.cuda.synchronize()
    got, got_counts = out.clone(), counts.clone()
    want, want_counts = moe_kernel.moe_experts(x, rw, ri, wg, wu, wd, shared,
                                               res)
    torch.cuda.synchronize()
    assert torch.equal(got_counts, want_counts)
    assert torch.equal(got, want)


def _cell_model(tmp_path, monkeypatch, dev):
  from portbench.reference import dsv2_weights
  model = _fbt(tmp_path, monkeypatch,
               ['--num_envs=128', '--hidden_size=256', '--vel_iters=8',
                '--pos_iters=4', '--window=25', '--ep_len=100'],
               dict(hidden_size=64, nfilter=16, vqD=16, vqK=64), '',
               'bfloat16', device=str(dev))
  dsv2_weights.load_into(model.module, 2147483701)
  return model


@pytest.mark.cuda
def test_cell_onestep_makes_no_host_sync_and_matches_the_reference(
    cuda_device, tmp_path, monkeypatch):
  """At the dream cell's shape (128 envs, window 25, DeepSeek-V2-Lite in
  bfloat16, weights drawn as the benchmark draws them): after a warm-up
  step (the graph captures of the encode and the transformer synchronise),
  a MoE layer and a whole onestep with carried codes run under
  set_sync_debug_mode('error'); the logits of the transformer's graph equal
  the eager module's, and against the float32 reference, teacher forced,
  lie within the cell's limits."""
  from portbench.checks import dream_dsv2
  dev = cuda_device
  model = _cell_model(tmp_path, monkeypatch, dev)
  wb = _window(model, 128)
  wb['lcd'] = wb['lcd'] * (torch.rand_like(wb['lcd']) < 0.2)
  wb['z'] = model.encode_window(wb)
  u = torch.rand((128, model.z_size), device=dev)
  got = {}
  transformer = model.transformer

  def recorded(z, a):
    out = transformer(z, a)
    got.update(z=z > 0.5, a=a.clone(), lg=out[:, 8].clone())
    return out
  model.transformer = recorded
  model.onestep(dict(wb), 7, None, u=u)      # captures the graphs
  torch.cuda.synchronize()
  moe = model.module.layers[3].mlp
  x = torch.randn((3200, 2048), device=dev).bfloat16()
  torch.cuda.set_sync_debug_mode('error')
  try:
    with torch.no_grad():
      moe(x)
    model.onestep(dict(wb), 8, None, u=u)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  cfg = model.module.cfg
  sd = dict(model.module.state_dict())
  with torch.no_grad():
    eager = model.module(got['z'].float(), got['a'])[:, 8]
    want = ref.logits(sd, got['z'].float(), got['a'], cfg)[:, 8]
  assert torch.equal(eager, got['lg'])       # the graph replays the eager
  assert model._graphs                       # kernels, in their order
  num, _ = dream_dsv2._logit_numbers([got['lg']], [want])
  lim = json.loads((ROOT / 'portbench/limits/dream.urchin-dsv2lite.json')
                   .read_text())
  assert num['logit_gap_p99'] <= lim['logit_gap_p99'], num
  assert num['logit_gap_max'] <= lim['logit_gap_max'], num
