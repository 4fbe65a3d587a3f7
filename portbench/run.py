"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. `BENCHMARK.json` names the cell's
configuration file and traffic mix; the traffic file
(`portbench/workloads/<traffic>.json`) names the generator that drives it
(`portbench/drivers/<driver>.py`), the comparison that decides `correct`
(`portbench/checks/<driver>.py`, limits in `portbench/limits/<cell>.json`)
and the end-to-end rate it reports; each per-layer metric is read by
`portbench/metrics/<metric>.py`. A new cell or metric is new files and
entries, never an edit of these.

The run needs as many CUDA devices as the cell asks for and stops with an
error, printing no result, where there are fewer: nothing falls back to the
CPU. Set-up (imports, kernel builds or loads from `build/`, the cell's
warm-up at its own shapes) counts into `setup_s`; then the window measures
`--seconds`; then the peak memory is read, the program's state freed and
the plain reference judges the window's output. With `--trace 1` the run
also times the stages of a dispatch and reports the per-layer metrics
instead of the end-to-end ones.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the last key of
that object.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the names a run must not have loaded: the JAX stack and the JAX package
# beside the port, compared as whole top-level module names
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'boxlcd_tpu')


def forbidden_modules(modules=None):
  """Sorted top-level names of loaded modules that are forbidden, each
  compared whole: `boxlcd_tpu_torch` is not `boxlcd_tpu`."""
  names = {m.split('.')[0] for m in (sys.modules if modules is None
                                      else modules)}
  return sorted(n for n in names if n in FORBIDDEN)


def cache_env(root):
  """Fixed cache directories inside the checkout, for any library of the
  program that compiles (the port builds its own kernels into build/)."""
  cache = Path(root) / 'build' / 'portbench-cache'
  os.environ.setdefault('TRITON_CACHE_DIR', str(cache / 'triton'))
  os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(cache / 'torch_extensions'))
  os.environ.setdefault('USE_FLAX', '0')
  os.environ.setdefault('USE_JAX', '0')


def load_cell(root, name):
  """(cell entry, configuration, traffic, limits, benchmark) by name."""
  bench = json.loads((Path(root) / 'BENCHMARK.json').read_text())
  cells = {w['name']: w for w in bench['workloads']}
  if name not in cells:
    raise SystemExit(f'unknown workload {name!r}; have {sorted(cells)}')
  cell = cells[name]
  cfg_entry = {c['name']: c for c in bench['configs']}[cell['config']]
  cfg = json.loads((Path(root) / cfg_entry['file']).read_text())
  traffic = json.loads(
      (HERE / 'workloads' / f'{cell["traffic"]}.json').read_text())
  limits = json.loads((HERE / 'limits' / f'{name}.json').read_text())
  return cell, cfg, traffic, limits, bench


def apply_overrides(cfg, traffic, overrides):
  """Lay {'config': {...}, 'traffic': {...}} over the files' entries, one
  level of nested dicts deep (the tests' small sizes)."""
  for key, d in (overrides or {}).items():
    target = cfg if key == 'config' else traffic
    for k, v in d.items():
      target[k] = dict(target[k], **v) if isinstance(v, dict) and \
          isinstance(target.get(k), dict) else v


def cell_metrics(bench, cell_name, kind):
  """The cell's end-to-end ('end_to_end') or per-layer ('per_layer')
  metric entries: those that list the cell, or list no cells."""
  return [m for m in bench[kind]
          if cell_name in m.get('workloads', [cell_name])]


def read_metric(name, rec):
  """portbench/metrics/<name>.py's read(rec), or None."""
  path = HERE / 'metrics' / f'{name}.py'
  if not path.exists():
    return None
  spec = importlib.util.spec_from_file_location(
      f'portbench.metrics.m_{abs(hash(name))}', path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  value = mod.read(rec)
  return None if value is None or not math.isfinite(value) else float(value)


def card_line():
  """nvidia-smi's name and power limit of the card, or None."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
         '--id=0'], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
  except (OSError, IndexError, subprocess.SubprocessError):
    return None


def card_setup(device, tf32=False):
  """The card as a run uses it: float32 matmuls and convolutions in full
  float32 (TF32 off, as the port's entry points set it), unless `tf32`
  (the dream's control)."""
  import torch
  torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
  torch.backends.cudnn.allow_tf32 = bool(tf32)
  torch.cuda.set_device(device)


def within(value, limit):
  return value is not None and not math.isnan(value) and value <= limit


def parse(argv):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def main(argv=None, device=None, root=None, overrides=None):
  """One run; returns the result dict (also printed). device='cpu' skips
  the look for a card and drives the rest of a run on the CPU (tests
  only); `overrides` ({'config': {...}, 'traffic': {...}}) lays small sizes
  over the files' (tests only)."""
  args = parse(argv)
  root = Path(root or os.getcwd())
  cache_env(root)
  cell, cfg, traffic, limits, bench = load_cell(root, args.workload)
  apply_overrides(cfg, traffic, overrides)
  import torch
  if device is None:
    need = int(cell['chips'])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
      print(f'portbench: {args.workload} needs {need} CUDA device(s), found '
            f'{have}; no result', file=sys.stderr)
      sys.exit(3)
    device = 'cuda:0'
  device = torch.device(device)
  on_card = device.type == 'cuda'
  if on_card:
    card_setup(device)
  driver = importlib.import_module(f'portbench.drivers.{traffic["driver"]}')
  check = importlib.import_module(f'portbench.checks.{traffic["driver"]}')

  run = driver.Cell(cfg, traffic, args.seed, device)
  run.warm()
  setup_s = time.perf_counter() - T0
  episodes, failed, steps, window_s = run.window(
      args.seconds, profile=bool(args.trace))
  peak = torch.cuda.max_memory_allocated(device) if on_card else 0

  metrics = {}
  breakdown_ = None
  if args.trace:
    rec = {'window_s': window_s, 'busy_s': None, 'steps': steps,
           'episodes': episodes, 'spans': run.spans}
    rec.update(run.traced())
    for m in cell_metrics(bench, args.workload, 'per_layer') if on_card else ():
      v = read_metric(m['name'], rec)
      if v is not None:
        metrics[m['name']] = {'value': v, 'unit': m['unit']}
    if on_card:
      breakdown_ = run.breakdown(rec)
  else:
    e2e = {'setup_s': setup_s, traffic['rate_metric']: steps / window_s}
    for m in cell_metrics(bench, args.workload, 'end_to_end'):
      if m['name'] in e2e:
        metrics[m['name']] = {'value': e2e[m['name']], 'unit': m['unit']}

  window_readings = run.readings()
  # the judgement: the program's state freed, then the plain reference
  ans = run.answers(args.seed)
  gen_device = run.device
  del run
  if on_card:
    torch.cuda.empty_cache()
  torch.set_num_threads(1)
  t_ref = time.perf_counter()
  numbers, readings = check.judge(cfg, traffic, ans, args.seed, gen_device)
  readings['reference_s'] = time.perf_counter() - t_ref
  readings.update(window_readings)
  readings['tripwire_ok'] = float(bool(ans['ok']))
  correct = (all(within(numbers.get(k), lim) for k, lim in limits.items())
             and failed == 0 and bool(ans['ok']))

  bad = forbidden_modules()
  if bad:
    print(f'portbench: forbidden modules loaded: {", ".join(bad)}; no result',
          file=sys.stderr)
    sys.exit(4)
  dev = {'platform': 'gpu' if on_card else 'cpu',
         'kind': torch.cuda.get_device_name(device) if on_card else 'cpu',
         'count': 1 if on_card else 0, 'memory_peak_bytes': int(peak)}
  if args.trace:
    dev.update(busy_s=rec['busy_s'] or 0.0, window_s=window_s)
  result = {'correct': bool(correct), 'attempted': int(episodes),
            'failed': int(failed), 'metrics': metrics, 'device': dev}
  if breakdown_ is not None:
    result['breakdown'] = breakdown_
  result['card'] = card_line() if on_card else None
  result['readings'] = readings
  result['checks'] = {k: {'value': numbers.get(k), 'limit': lim}
                      for k, lim in limits.items()}
  for k, lim in limits.items():
    print(f'check {k} {numbers.get(k)!r} limit {lim!r}', file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
