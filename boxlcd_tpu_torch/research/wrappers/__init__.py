from boxlcd_tpu_torch.research.wrappers.body_goal import BodyGoalEnv
from boxlcd_tpu_torch.research.wrappers.cube_goal import CubeGoalEnv
from boxlcd_tpu_torch.research.wrappers.learned_env import (
    LearnedEnv, RewardLenv)
from boxlcd_tpu_torch.research.wrappers.preproc_vec_env import PreprocVecEnv
from boxlcd_tpu_torch.research.wrappers.sync_vector_env import SyncVectorEnv
from boxlcd_tpu_torch.research.wrappers.vec_env import VecEnv
from boxlcd_tpu_torch.research.wrappers.wrapped_gym import WrappedGym

__all__ = ['BodyGoalEnv', 'CubeGoalEnv', 'LearnedEnv', 'PreprocVecEnv',
           'RewardLenv', 'SyncVectorEnv', 'VecEnv', 'WrappedGym']
