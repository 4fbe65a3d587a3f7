"""Video-model registry (the port of research/nets/video_models/__init__.py):
all four of the JAX package's video models, in its order, then the port's
own FBTDSV2 (the FBT with a DeepSeek-V2 transformer)."""
from boxlcd_tpu_torch.research.nets.video_models.fbt import FBT
from boxlcd_tpu_torch.research.nets.video_models.fbt_dsv2 import FBTDSV2
from boxlcd_tpu_torch.research.nets.video_models.fit import FIT
from boxlcd_tpu_torch.research.nets.video_models.frnld import FRNLD
from boxlcd_tpu_torch.research.nets.video_models.rssm import RSSM

video_map = {cls.__name__: cls for cls in (FBT, FIT, FRNLD, RSSM,
                                            FBTDSV2)}
