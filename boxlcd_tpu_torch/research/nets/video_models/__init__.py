"""Video-model registry (the port of research/nets/video_models/__init__.py):
the ported video models only."""
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT

video_map = {'FBT': FBT}
