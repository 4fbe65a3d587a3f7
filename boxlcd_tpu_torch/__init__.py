"""boxlcd_tpu_torch — the PyTorch/CUDA port of boxlcd_tpu.

The same learned-simulator testbed for one NVIDIA H100: fixed-shape batched
2D rigid-body physics in torch over a leading worlds axis, the exact LCD
raster, barrel collection and the per-step batched env (research.wrappers)
on top, and hand-written CUDA kernels (csrc/) for every kernel the JAX
package wrote for the TPU. Entry points run on the card unless the caller
passes another device. Importing the package touches no device and builds
nothing.
"""
__version__ = '0.1.0'

from boxlcd_tpu_torch.utils import AttrDict, A
from boxlcd_tpu_torch.world_defs import Object, Body, Joint, Robot, WorldDef
from boxlcd_tpu_torch.envs import Env, WorldEnv, env_map
from boxlcd_tpu_torch.envs.env import Env as _Env

ENV_DG = AttrDict(_Env.ENV_DG)

__all__ = ['AttrDict', 'A', 'Object', 'Body', 'Joint', 'Robot', 'WorldDef',
           'Env', 'WorldEnv', 'env_map', 'ENV_DG']
