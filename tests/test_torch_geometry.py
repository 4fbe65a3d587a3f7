"""The physics kernels' launch geometry (engine/mega.launch_geometry), which
the C launch functions of csrc/mega_rollout.cu and csrc/batched_solver.cu
receive and check, and its shared-memory layout, mirrored from
csrc/physics_stages.cuh: a group of G lanes per world, G a power of two of
at least the spec's bodies, blocks that cover the batch, shared memory
within one H100 block's. Pure Python: no kernel, no JAX."""
import re
from pathlib import Path

import numpy as np
import pytest

import boxlcd_tpu_torch
from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.engine import mega

ENVS = sorted(boxlcd_tpu_torch.env_map)
BATCHES = [1, 33, 4000, 4096]
HEADER = (Path(mega.__file__).resolve().parents[1] / 'csrc'
          / 'physics_stages.cuh').read_text()


def _spec(name):
  return boxlcd_tpu_torch.env_map[name](device='cpu').spec


@pytest.mark.parametrize('env_name', ENVS)
def test_launch_geometry_fits_the_spec_and_the_card(env_name):
  spec = _spec(env_name)
  ftab, itab = mega.spec_tables(spec)
  static = (len(ftab) + len(itab)) * 4         # SpecF + SpecI in shared
  for B in BATCHES:
    geo = mega.launch_geometry(spec, B)
    G = geo.group
    assert G >= spec.n and G in mega.GROUP_SIZES and G & (G - 1) == 0
    assert geo.threads == G * geo.worlds <= 128 and geo.threads % 32 == 0
    assert geo.blocks * geo.worlds >= B > (geo.blocks - 1) * geo.worlds
    words = mega.world_words(G, len(spec.pair_a), len(spec.j_parent))
    assert geo.shared == geo.worlds * words * 4
    assert geo.shared + static <= utils.MAX_SHARED_BYTES
    # a batch that can give every SM a block does
    if B * G >= 32 * utils.NUM_SMS:
      assert geo.blocks >= utils.NUM_SMS, (B, geo)


@pytest.mark.parametrize('env_name,B,want', [
    ('Urchin', 4000, (4, 16, 250)),    # the main path: 250 blocks of 64
    ('Urchin', 4096, (4, 16, 256)),    # the solver path
    ('Urchin', 1024, (4, 8, 128)),     # blocks of 32 when 64 leave SMs idle
    ('LuxoCube', 1024, (8, 4, 256)),
    ('CrabCube', 1000, (32, 4, 250)),
    ('Dropbox', 1, (4, 8, 1)),
])
def test_launch_geometry_examples(env_name, B, want):
  geo = mega.launch_geometry(_spec(env_name), B)
  assert (geo.group, geo.worlds, geo.blocks) == want


def test_launch_geometry_takes_a_block_size():
  spec = _spec('Urchin')
  for threads in mega.BLOCK_THREADS:
    geo = mega.launch_geometry(spec, 4000, threads)
    assert geo.threads == threads and geo.blocks == -(-4000 // geo.worlds)
  with pytest.raises(ValueError):
    mega.launch_geometry(_spec('CrabCube'), 10, threads=16)   # < G lanes
  with pytest.raises(ValueError):
    mega.launch_geometry(spec, 10, threads=256)


@pytest.mark.parametrize('G', mega.GROUP_SIZES)
def test_world_slices_start_on_distinct_banks(G):
  """The worlds of a warp start G banks apart, so lane (k, i) of the
  body-parallel stages and lane 0 of each world in the serial chains meet
  no bank conflict."""
  for n_pairs in range(16):
    for n_joints in range(17):
      words = mega.world_words(G, n_pairs, n_joints)
      assert words % 32 == G % 32
      assert 0 <= words - (mega.BODY_ARRAYS * G + mega.PAIR_WORDS * n_pairs
                           + mega.JOINT_WORDS * n_joints) < 32
      banks = {(k * words + i) % 32 for k in range(32 // G) for i in range(G)}
      assert len(banks) == 32 // G * G


def test_layout_constants_mirror_the_header():
  consts = dict(re.findall(r'constexpr int (BODY_ARRAYS|PAIR_WORDS|'
                           r'JOINT_WORDS) = (\d+);', HEADER))
  assert {k: int(v) for k, v in consts.items()} == {
      'BODY_ARRAYS': mega.BODY_ARRAYS, 'PAIR_WORDS': mega.PAIR_WORDS,
      'JOINT_WORDS': mega.JOINT_WORDS}
  # World's accessors use arrays 0 .. BODY_ARRAYS - 1, each once
  world = HEADER[HEADER.index('struct World {'):]
  world = world[:world.index('};')]
  idx = [int(k) if k else (1 if g else 0) for k, g in re.findall(
      r'\[(?:(\d+) \* G|(G)) \+ i\]|b\[i\]', world)]
  assert sorted(idx) == list(range(mega.BODY_ARRAYS))
  # the padding rule, as the header writes it
  assert 'w + ((G % 32) - w % 32 + 32) % 32' in HEADER


def test_group_size_rounds_bodies_up():
  for name in ENVS:
    spec = _spec(name)
    G = mega.group_size(spec)
    assert G == max(4, int(2 ** np.ceil(np.log2(spec.n)))), name

