from boxlcd_tpu_torch.research.runners.trainer import Trainer

__all__ = ['Trainer']
