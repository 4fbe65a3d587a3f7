"""The readings that a cell's limits are set from, on the chip at the cell's
own size, seed after seed in one process:

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        [--seconds 1] [--out chiprun_out/control.jsonl]

For each seed: the cell's warm-up and a short window at its own load, then
the window's last dispatch or call judged against the plain reference as
the program delivered it (the lower readings), and the control, whose
readings have to fail a limit. The control is the one the cell's check
names in `CONTROL`: 'bf16', the reference held in bfloat16 in the
program's place (float32 arithmetic with no TF32 path: the physics), or
'tf32', the program itself run again on the same seed with TF32 on for its
matmuls and convolutions (float32 with TF32 off: the nets), judged with
TF32 off; a 'tf32' cell reports the bfloat16 reference as `control_bf16`
beside it. One JSON line a seed. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import time
from pathlib import Path

from portbench import run


def main(argv=None, device=None, root=None, overrides=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', required=True)
  p.add_argument('--seconds', type=float, default=1.0)
  p.add_argument('--out', default='')
  args = p.parse_args(argv)
  root = Path(root or os.getcwd())
  run.cache_env(root)
  import torch
  _, cfg, traffic, limits, _ = run.load_cell(root, args.workload)
  run.apply_overrides(cfg, traffic, overrides)
  device = torch.device(device or 'cuda:0')
  driver = importlib.import_module(f'portbench.drivers.{traffic["driver"]}')
  check = importlib.import_module(f'portbench.checks.{traffic["driver"]}')
  lines = []
  on_card = device.type == 'cuda'
  kind = getattr(check, 'CONTROL', 'bf16')

  def answers(seed, tf32=False):
    if on_card:
      run.card_setup(device, tf32)
    cellrun = driver.Cell(cfg, traffic, seed, device)
    cellrun.warm()
    cellrun.window(args.seconds)
    ans = cellrun.answers(seed)
    del cellrun
    if on_card:
      run.card_setup(device)
    return ans

  for seed in (int(s) for s in args.seeds.split(',')):
    ans = answers(seed)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    prog, prog_seen = check.judge(cfg, traffic, ans, seed, device)
    t_ref = time.perf_counter() - t0
    line = {'workload': args.workload, 'seed': seed, 'control_kind': kind,
            'program': prog, 'program_readings': prog_seen}
    bf16, bf16_seen = check.judge(cfg, traffic, ans, seed, device, bf16=True)
    if kind == 'tf32':
      ctl, ctl_seen = check.judge(cfg, traffic, answers(seed, tf32=True),
                                  seed, device)
      line.update(control_bf16=bf16, control_bf16_readings=bf16_seen)
    else:
      ctl, ctl_seen = bf16, bf16_seen
    line.update(control=ctl, control_readings=ctl_seen, limits=limits,
                tripwire_ok=bool(ans['ok']), reference_s=t_ref)
    print(json.dumps(line), flush=True)
    lines.append(line)
    if args.out:
      Path(args.out).parent.mkdir(parents=True, exist_ok=True)
      with open(args.out, 'a') as f:
        f.write(json.dumps(line) + '\n')
  return lines


if __name__ == '__main__':
  main()
