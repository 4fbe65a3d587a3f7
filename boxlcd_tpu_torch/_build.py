"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` exposes a plain C interface and compiles with `nvcc`
alone (no PyTorch headers, so a build takes seconds) into
`build/kernels/lib<name>-<digest>.so` at the repository root; the digest
covers the source, the shared `csrc/*.cuh` headers and the flags, so an
edited source rebuilds. Libraries are
loaded with ctypes. Sources are built in parallel, one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']

# name -> {'seconds': build time (0.0 when already built), 'log': nvcc output}
BUILD_INFO = {}
_LIBS = {}


def _nvcc() -> str:
  path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit')
  return path


def sources():
  return sorted(p.stem for p in CSRC.glob('*.cu'))


def _target(name: str) -> Path:
  # the digest covers the shared headers too: an edited header rebuilds
  src = b''.join(p.read_bytes() for p in
                 [CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))])
  digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
  return BUILD_DIR / f'lib{name}-{digest}.so'


def build_all(names=None):
  """Compile every named source (default: all of csrc/) that is not built
  yet, all nvcc processes at once; raises on the first failed build."""
  names = list(names or sources())
  todo = [n for n in names if not _target(n).exists()]
  for n in names:
    if n not in todo:
      BUILD_INFO.setdefault(n, {'seconds': 0.0, 'log': ''})
  if not todo:
    return BUILD_INFO
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  procs = {}
  t0 = time.time()
  for n in todo:
    tmp = _target(n).with_suffix(f'.{os.getpid()}.tmp')
    procs[n] = (tmp, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{n}.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  failed = []
  for n, (tmp, proc) in procs.items():
    log, _ = proc.communicate()
    BUILD_INFO[n] = {'seconds': time.time() - t0, 'log': log}
    if proc.returncode != 0:
      failed.append(f'{n}: nvcc exited {proc.returncode}\n{log}')
    else:
      os.replace(tmp, _target(n))
  if failed:
    raise RuntimeError('CUDA build failed:\n' + '\n'.join(failed))
  return BUILD_INFO


def load(name: str) -> ctypes.CDLL:
  """The built library of csrc/<name>.cu, building it first if needed."""
  if name not in _LIBS:
    build_all([name])
    _LIBS[name] = ctypes.CDLL(str(_target(name)))
  return _LIBS[name]
