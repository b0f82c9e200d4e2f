"""Counterpart of the JAX package's `utils` subpackage."""
