"""Autoencoder registry (the port of research/nets/autoencoders/__init__.py):
all seven of the JAX package's autoencoders, in its order."""
from boxlcd_tpu_torch.research.nets.autoencoders.arbiter import ArbiterAE
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE
from boxlcd_tpu_torch.research.nets.autoencoders.multistep_arbiter import (
    MultiStepArbiter)
from boxlcd_tpu_torch.research.nets.autoencoders.object_localizer import (
    ObjectLocalizer)
from boxlcd_tpu_torch.research.nets.autoencoders.rnlda import RNLDA
from boxlcd_tpu_torch.research.nets.autoencoders.vae import VAE
from boxlcd_tpu_torch.research.nets.autoencoders.vqvae import VQVAE

ae_map = {cls.__name__: cls for cls in (BVAE, VAE, RNLDA, ArbiterAE,
                                        MultiStepArbiter, ObjectLocalizer,
                                        VQVAE)}
