"""Posed-RGBD datasets (the port's own copies of the JAX package's jax-free
loaders)."""

from .generic import RGBDDataset, RGBDFrame
from .synthetic import Box, SyntheticDataset, SyntheticScene
