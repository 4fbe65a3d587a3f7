from boxlcd_tpu_torch.research.runners.evaler import Evaler
from boxlcd_tpu_torch.research.runners.fiddler import Fiddler
from boxlcd_tpu_torch.research.runners.trainer import Trainer
from boxlcd_tpu_torch.research.runners.vizer import InteractiveVizer, Vizer

__all__ = ['Evaler', 'Fiddler', 'InteractiveVizer', 'Trainer', 'Vizer']
