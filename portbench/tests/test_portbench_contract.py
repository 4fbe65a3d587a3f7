"""BENCHMARK.json against the benchmark's contract: names, units, the files
each entry is found by, the metrics each cell reports, and the chip time a
full check takes with the largest number of cells."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\n\t]{1,200}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


def all_names():
  out = [c['name'] for c in BENCH['configs']]
  for w in BENCH['workloads']:
    out += [w['name'], w['config'], w['traffic']]
  out += [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
  for c in BENCH['configs']:
    out += c['reduced']
  return out


def test_keys_and_sizes():
  assert set(BENCH) == KEYS
  assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024
  assert 1 <= len(BENCH['paths']) <= 16
  assert all(PATH.match(p) and '..' not in p and not p.startswith('/')
             for p in BENCH['paths'])
  assert 1 <= len(BENCH['command']) <= 32
  assert all(LINE.match(w) for w in BENCH['command'])
  assert 1 <= len(BENCH['configs']) <= 24
  assert 1 <= len(BENCH['workloads']) <= 24
  assert 1 <= len(BENCH['end_to_end']) <= 16
  assert 1 <= len(BENCH['per_layer']) <= 128
  assert isinstance(BENCH['run_seconds'], int) and \
      1 <= BENCH['run_seconds'] <= 51


@pytest.mark.parametrize('name', all_names())
def test_name_characters(name):
  assert NAME.match(name), name


def test_units_and_lines():
  for m in BENCH['end_to_end'] + BENCH['per_layer']:
    assert UNIT.match(m['unit']), m['unit']
    assert m['better'] in ('lower', 'higher')
  for item in BENCH['workloads'] + BENCH['configs']:
    assert LINE.match(item['why'])
  for m in BENCH['per_layer']:
    assert LINE.match(m['layer'])
  for c in BENCH['configs']:
    assert LINE.match(c['source']) and c['source'].startswith('https://')


def test_unique_names():
  for group in ('configs', 'workloads'):
    names = [x['name'] for x in BENCH[group]]
    assert len(names) == len(set(names))
  metrics = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
  assert len(metrics) == len(set(metrics))
  pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
  assert len(pairs) == len(set(pairs))


def test_entries_have_exactly_their_keys():
  for c in BENCH['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
  for w in BENCH['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert w['chips'] in (1, 4)
  for m in BENCH['end_to_end']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                      'source'}
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25
  for m in BENCH['per_layer']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                      'layer', 'moves'}
    assert m['source'] in ('device_trace', 'program_span', 'program_counter',
                           'host_clock')


def test_files_found_by_name():
  used = {w['config'] for w in BENCH['workloads']}
  assert used == {c['name'] for c in BENCH['configs']}
  files = [c['file'] for c in BENCH['configs']]
  assert len(files) == len(set(files))
  for c in BENCH['configs']:
    assert any(c['file'].startswith(p + '/') for p in BENCH['paths'])
    cfg = json.loads((ROOT / c['file']).read_text())
    assert cfg['name'] == c['name']
  for w in BENCH['workloads']:
    traffic = json.loads(
        (ROOT / 'portbench/workloads' / f'{w["traffic"]}.json').read_text())
    assert (ROOT / 'portbench/drivers' / f'{traffic["driver"]}.py').exists()
    assert (ROOT / 'portbench/checks' / f'{traffic["driver"]}.py').exists()
    assert (ROOT / 'portbench/limits' / f'{w["name"]}.json').exists()
  for m in BENCH['per_layer']:
    assert (ROOT / 'portbench/metrics' / f'{m["name"]}.py').exists()


def reported(cell):
  """The end-to-end metrics a cell reports."""
  return {m['name'] for m in BENCH['end_to_end']
          if cell in m.get('workloads', [cell])}


def test_every_cell_reports_enough():
  for w in BENCH['workloads']:
    e2e = reported(w['name'])
    assert 'setup_s' in e2e and len(e2e) >= 2, w['name']
    traffic = json.loads((ROOT / 'portbench/workloads' /
                          f'{w["traffic"]}.json').read_text())
    assert traffic['rate_metric'] in e2e
    layer = [m for m in BENCH['per_layer']
             if w['name'] in m.get('workloads', [w['name']])]
    assert layer, w['name']
  assert {m['name'] for m in BENCH['end_to_end']} >= {'setup_s'}
  setup = [m for m in BENCH['end_to_end'] if m['name'] == 'setup_s'][0]
  assert 'workloads' not in setup and setup['bound'] <= 0.25


def test_per_layer_moves_a_metric_of_each_cell():
  """Every per-layer metric names one end-to-end metric that each of its
  cells reports; metrics of one layer name it letter for letter."""
  e2e = {m['name'] for m in BENCH['end_to_end']}
  cells = {w['name'] for w in BENCH['workloads']}
  for m in BENCH['per_layer']:
    assert m['moves'] in e2e and m['moves'] != 'setup_s'
    for cell in m.get('workloads', cells):
      assert cell in cells
      assert m['moves'] in reported(cell), (m['name'], cell)
  for m in BENCH['per_layer']:
    if m['name'].split('.')[0].endswith('_roofline') or 'mfu' in m['name']:
      assert m['unit'] == '%'


def test_four_chip_cells_and_budget():
  cells = BENCH['workloads']
  four = sum(w['chips'] == 4 for w in cells)
  assert four <= max(1, len(cells) // 4)
  s = BENCH['run_seconds']
  full = (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200
  assert full <= 43200


def test_paths_hold_the_command():
  cmd = BENCH['command']
  assert cmd[:3] == ['python3', '-m', 'portbench.run']
  assert BENCH['paths'] == ['portbench']
