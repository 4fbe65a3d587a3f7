"""The raster kernels' launch geometry (render/cuda_raster.launch_geometry),
which the C launch functions of csrc/lcd_raster.cu and csrc/traj_raster.cu
receive and check, and the body-slot layout it mirrors from
csrc/lcd_common.cuh: a tile of G lanes per frame (H rounded up to a power of
two, within a warp, at least a body's group of NV lanes), one warp a block,
blocks that cover the frames, shared memory within one H100 block's.
Pure Python: no kernel, no JAX."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import boxlcd_tpu_torch
from boxlcd_tpu_torch import utils
from boxlcd_tpu_torch.render import cuda_raster

# one intra-op thread: the tensors here are small, and where the suite runs
# its files in parallel processes, more threads only contend for the cores
torch.set_num_threads(1)

HEADER = (Path(cuda_raster.__file__).resolve().parents[1] / 'csrc'
          / 'lcd_common.cuh').read_text()
# (env, W, H) the rasters run at: native widths, and CrabCube cut to 32 wide
SIZES = [('Urchin', 32, 16), ('LuxoCube', 24, 16), ('Object3', 16, 16),
         ('Bounce2', 16, 16), ('Luxo', 32, 16), ('CrabCube', 32, 32),
         ('CrabCube', 32, 16), ('Urchin', 32, 5)]
FRAMES = [1, 8, 16, 4000, 4096, 262144, 400000]


def _spec(name):
  return boxlcd_tpu_torch.env_map[name](device='cpu').spec


@pytest.mark.parametrize('env_name,width,height', SIZES)
def test_launch_geometry_fits_the_frames_and_the_card(env_name, width, height):
  spec = _spec(env_name)
  nv = cuda_raster.vertex_bound(spec)
  assert nv in cuda_raster.VERTEX_BOUNDS and nv >= max(spec.nverts)
  words = cuda_raster.frame_words(spec.n, height, nv)
  for F in FRAMES:
    geo = cuda_raster.launch_geometry(spec, F, height)
    G = geo.lanes
    assert G & (G - 1) == 0 and nv <= G <= 32 and (G >= height or G == 32)
    assert geo.nv == nv
    assert geo.threads == cuda_raster.THREADS == G * geo.frames == 32
    assert geo.blocks * geo.frames >= F > (geo.blocks - 1) * geo.frames
    assert geo.shared == geo.frames * words * 4 <= utils.MAX_SHARED_BYTES
    # frames that can give every SM a block of one warp do
    if F * G >= 32 * utils.NUM_SMS:
      assert geo.blocks >= utils.NUM_SMS, (F, geo)


@pytest.mark.parametrize('env_name,F,H,want', [
    ('Urchin', 400000, 16, (16, 2, 200000, 4)),  # traj: 100 steps x 4000
    ('Urchin', 4000, 16, (16, 2, 2000, 4)),      # the per-step paths
    ('Urchin', 16, 16, (16, 2, 8, 4)),           # the tripwire
    ('Luxo', 8, 16, (16, 2, 4, 4)),              # the VecEnv
    ('CrabCube', 4096, 32, (32, 1, 4096, 8)),    # 6-vertex bodies: NV = 8
    ('Urchin', 64, 5, (8, 4, 16, 4)),
])
def test_launch_geometry_examples(env_name, F, H, want):
  geo = cuda_raster.launch_geometry(_spec(env_name), F, H)
  assert (geo.lanes, geo.frames, geo.blocks, geo.nv) == want


@pytest.mark.parametrize('height', [1, 3, 5, 8, 16, 17, 32, 64])
def test_launch_geometry_is_one_warp_at_every_height(height):
  """Every frame height fills a one-warp block with whole tiles, each
  frame's rows on lanes of its own tile (G >= H up to a warp)."""
  for env_name in ('Urchin', 'CrabCube'):
    spec = _spec(env_name)
    geo = cuda_raster.launch_geometry(spec, 1000, height)
    assert geo.lanes * geo.frames == geo.threads == 32
    assert geo.lanes >= min(height, 32) and geo.lanes >= geo.nv
    assert geo.blocks == -(-1000 // geo.frames)
    assert geo.shared == geo.frames * cuda_raster.frame_words(
        spec.n, height, geo.nv) * 4


def test_vertex_bound_takes_the_largest_vertex_count():
  assert cuda_raster.vertex_bound(_spec('Urchin')) == 4
  crab = _spec('CrabCube')
  assert max(crab.nverts) == 6 and cuda_raster.vertex_bound(crab) == 8
  too_many = dataclasses.replace(crab, nverts=np.full_like(crab.nverts, 9))
  with pytest.raises(ValueError):
    cuda_raster.vertex_bound(too_many)


def test_tile_lanes():
  for H, nv, G in ((16, 4, 16), (32, 8, 32), (64, 4, 32), (5, 4, 8),
                   (3, 4, 4), (3, 8, 8), (17, 4, 32)):
    assert cuda_raster.tile_lanes(H, nv) == G


def test_layout_constants_mirror_the_header():
  consts = dict(re.findall(r'constexpr int (THREADS|HEAD_WORDS|'
                           r'EDGE_ARRAYS) = (\d+);', HEADER))
  assert {k: int(v) for k, v in consts.items()} == {
      'THREADS': cuda_raster.THREADS,
      'HEAD_WORDS': cuda_raster.HEAD_WORDS,
      'EDGE_ARRAYS': cuda_raster.EDGE_ARRAYS}
