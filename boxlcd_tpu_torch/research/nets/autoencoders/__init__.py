"""Autoencoder registry (the port of research/nets/autoencoders/__init__.py):
the ported autoencoders only."""
from boxlcd_tpu_torch.research.nets.autoencoders.bvae import BVAE

ae_map = {'BVAE': BVAE}
