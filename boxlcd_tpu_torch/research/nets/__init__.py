"""Model registry (the port of research/nets/__init__.py): the seven
autoencoders + the four video models."""
from boxlcd_tpu_torch.research.nets.autoencoders import ae_map
from boxlcd_tpu_torch.research.nets.video_models import video_map

net_map = {}
net_map.update(ae_map)
net_map.update(video_map)
