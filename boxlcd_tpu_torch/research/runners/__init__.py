from boxlcd_tpu_torch.research.runners.evaler import Evaler
from boxlcd_tpu_torch.research.runners.trainer import Trainer

__all__ = ['Evaler', 'Trainer']
