"""The DeepSeek-V2 dream cell (dream.urchin-dsv2lite) at a tiny size on the
CPU: a run end to end, its control, a planted fault; the frozen yardstick
(`portbench/yardstick_dsv2.py`) at DeepSeek-V2-Lite's widths; the per-layer
readers on a record and on a record without the model; the frozen
reference against the port's."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import control, run, yardstick_dsv2
from portbench.metrics import _dsv2

ROOT = Path(__file__).resolve().parents[2]
CELL = 'dream.urchin-dsv2lite'
SMALL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=16,
             qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
# float32: at this size a bfloat16 token routed to another expert at a tie
# of the top-2 of 8 moves the logits past the card's limits; the card runs
# the cell's bfloat16 (tests/test_torch_dsv2.py, the cell's runs)
CONFIG = dict(SMALL, env_config={'ep_len': 6, 'vel_iters': 2, 'pos_iters': 1},
              bvae={'hidden_size': 16, 'vqK': 16, 'vqD': 4, 'nfilter': 8,
                    'window': 5},
              world_model={'window': 6, 'precision': 'float32'},
              ppo={'num_envs': 4, 'steps_per_epoch': 32, 'hidden_size': 32})
TRAFFIC = {'steps': 8, 'warm_steps': 7, 'check': {'steps': 3,
                                                   'carry_steps': 8}}
LITE = json.loads((ROOT / 'portbench/configs/urchin-dsv2lite.json')
                  .read_text())


def tiny_run(seed=2 ** 31 + 91, trace=0):
  return run.main(['--workload', CELL, '--seed', str(seed), '--seconds',
                   '0.05', '--trace', str(trace)], device='cpu', root=ROOT,
                  overrides={'config': CONFIG, 'traffic': TRAFFIC})


def test_tiny_run_is_correct(capsys):
  res = tiny_run()
  out, _ = capsys.readouterr()
  line = json.loads(out.strip().splitlines()[-1])
  assert line == json.loads(json.dumps(res))
  assert res['correct'] and res['failed'] == 0 and res['attempted'] > 0
  assert set(line['metrics']) == {'setup_s', 'dream_env_steps_per_s'}
  limits = json.loads((ROOT / f'portbench/limits/{CELL}.json').read_text())
  assert set(line['checks']) == set(limits)
  assert line['readings']['dream_steps_checked'] == 3


def test_tiny_traced_run_reports_no_device_metric_off_the_card():
  res = tiny_run(trace=1)
  assert res['correct'] and res['metrics'] == {}


def test_control_fails_a_limit():
  """The reference with float8 matmul inputs in the program's place fails
  a limit where the program's readings of the same call pass them all."""
  lines = control.main(['--workload', CELL, '--seeds', '3', '--seconds',
                        '0.05'], device='cpu', root=ROOT,
                       overrides={'config': CONFIG, 'traffic': TRAFFIC})
  for line in lines:
    lim = line['limits']
    assert line['control_kind'] == 'float8'
    assert all(line['program'][k] <= v for k, v in lim.items())
    assert any(line['control'][k] > v for k, v in lim.items())


def test_altered_logits_fail(monkeypatch):
  from boxlcd_tpu_torch.research.nets.dsv2 import DSV2Module
  head = DSV2Module.head
  monkeypatch.setattr(DSV2Module, 'head',
                      lambda self, x: head(self, x) * 1.5)
  res = tiny_run()
  assert not res['correct'], res['checks']


def test_configuration_is_the_published_model():
  assert LITE['name'] == 'urchin-dsv2lite'
  assert LITE['num_hidden_layers'] == 27 and LITE['hidden_size'] == 2048
  assert (LITE['n_routed_experts'], LITE['n_shared_experts'],
          LITE['num_experts_per_tok']) == (64, 2, 6)
  assert (LITE['kv_lora_rank'], LITE['qk_nope_head_dim'],
          LITE['qk_rope_head_dim'], LITE['v_head_dim'],
          LITE['num_attention_heads']) == (512, 128, 64, 128, 16)
  assert LITE['reduced'] == ['vocab_size'] and LITE['vocab_size'] == 512
  bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
  entry = [c for c in bench['configs'] if c['name'] == LITE['name']][0]
  assert entry['reduced'] == LITE['reduced']
  assert entry['source'] == LITE['source']


def test_yardstick_at_the_published_widths():
  # 2,241.6 M multiply-adds a token: 14.35 TFLOP over 3,200 tokens
  assert abs(yardstick_dsv2.matmul_flops(LITE, 3200) - 14.346e12) < 1e9
  assert yardstick_dsv2.moe_layers(LITE) == 26
  assert abs(yardstick_dsv2.expert_weight_bytes(LITE) - 1.1073e9) < 1e5
  slots = 3200 * 6
  flops_s = 2 * slots * 3 * 2048 * 1408 / yardstick_dsv2.BF16_FLOPS
  bytes_s = (1.107296256e9 + 2 * slots * 2048 * 2) / \
      yardstick_dsv2.HBM_BYTES_PER_S
  assert yardstick_dsv2.moe_expert_bound(LITE, slots) == max(flops_s,
                                                             bytes_s)
  s = {'cfg': LITE, 'B': 128, 'W': 25, 'H': 16, 'Wd': 32, 'P': 13, 'A': 3,
       'hidden': 64, 'nfilter': 16, 'vqD': 16, 'zH': 4, 'zW': 8,
       'ppo_hidden': 256}
  step = yardstick_dsv2.dsv2_step_flops(s)
  assert 14.346e12 < step < 14.346e12 * 1.01


def _record(cfg, steps=10, routed=None, kernel_s=None):
  moe = yardstick_dsv2.moe_layers(cfg)
  return {'window_s': 2.0, 'dream_steps': steps, 'busy_s': 1.5,
          'yard': {'cfg': cfg, 'B': 128, 'W': 25, 'H': 16, 'Wd': 32,
                   'P': 13, 'A': 3, 'hidden': 64, 'nfilter': 16, 'vqD': 16,
                   'zH': 4, 'zW': 8, 'ppo_hidden': 256},
          'kernels': {
              '(anonymous namespace)::moe_gate_up_kernel(bf16 const*)':
              (kernel_s, moe * steps),
              '(anonymous namespace)::moe_down_kernel(bf16 const*)':
              (0.0, moe * steps), 'ampere_bf16_gemm': (1.0, steps)}
          if kernel_s else {},
          'program': {'spans': [], 'counters': {
              'moe.tokens_routed': routed}} if routed else None}


def test_readers_on_a_record_and_on_one_without_the_model():
  rec = _record(LITE, routed=10 * 26 * 19200, kernel_s=0.5)
  want = 100 * 10 * 26 * yardstick_dsv2.moe_expert_bound(LITE, 19200) / 0.5
  assert abs(_dsv2.moe_roofline(rec) - want) < 1e-9
  assert _dsv2.mfu(rec) > 0
  # the span metrics read the eager calls: device us inside a span / calls
  span = lambda n, a, b: {'name': n, 'start_us': a, 'end_us': b, 'id': 0,
                          'parent': None, 'root': 0}
  rec['eager'] = {'program': {'spans': [span('dsv2.attn', 0, 10),
                                        span('dsv2.moe', 10, 20)],
                              'counters': {}},
                  'events': {'device': [('a', 30, 42, 1), ('m', 42, 72, 2)],
                             'runtime': [('cudaLaunchKernel', 5, 6, 1),
                                         ('cuLaunchKernel', 15, 16, 2)]},
                  'calls': 2}
  assert abs(_dsv2.attn_span_ms(rec) - 0.006) < 1e-12
  assert abs(_dsv2.moe_span_ms(rec) - 0.015) < 1e-12
  bare = _record(LITE)
  assert _dsv2.moe_roofline(bare) is None
  assert _dsv2.moe_span_ms(bare) is None and _dsv2.attn_span_ms(bare) is None
  for name in ('mfu.dream_dsv2', 'moe_roofline.dream_dsv2',
               'moe_span_ms.dream_dsv2', 'attn_span_ms.dream_dsv2',
               'idle_pct.dream_dsv2'):
    assert run.read_metric(name, {}) is None


def test_frozen_reference_is_the_ports():
  from boxlcd_tpu_torch.research.nets import dsv2
  from boxlcd_tpu_torch.research.nets.reference import dsv2_ref
  from portbench.reference import dsv2 as frozen
  cfg = dsv2.config(SMALL)
  torch.manual_seed(0)
  m = dsv2.DSV2Module(cfg, 6, 32, 3)
  z = (torch.rand(2, 6, 32) > 0.5).float()
  a = torch.rand(2, 6, 3)
  sd = m.state_dict()
  assert torch.equal(frozen.logits(sd, z, a, cfg),
                     dsv2_ref.logits(sd, z, a, cfg))
  assert frozen.param_shapes(cfg, 32, 3) == dsv2_ref.param_shapes(cfg, 32,
                                                                  3)


def test_benchmark_side_imports_nothing_of_the_program():
  code = ('import sys; import portbench.reference.dsv2, '
          'portbench.reference.dsv2_weights, portbench.checks.dream_dsv2, '
          'portbench.yardstick_dsv2, portbench.metrics._dsv2, '
          'portbench.drivers.dream_dsv2; '
          'bad = sorted({m.split(".")[0] for m in sys.modules} & '
          '{"boxlcd_tpu_torch", "boxlcd_tpu", "jax", "jaxlib", "flax"}); '
          'print(bad); sys.exit(1 if bad else 0)')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True)
  assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
  """A short run of the cell on the card, in its own process, is correct
  and reports the card."""
  out = subprocess.run(
      [sys.executable, '-m', 'portbench.run', '--workload', CELL, '--seed',
       '2147483663', '--seconds', '2', '--trace', '0'], cwd=ROOT,
      capture_output=True, text=True, timeout=900)
  assert out.returncode == 0, out.stderr[-4000:]
  line = json.loads(out.stdout.strip().splitlines()[-1])
  assert line['correct'] and line['device']['platform'] == 'gpu'
