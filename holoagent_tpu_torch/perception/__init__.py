"""Counterpart of the JAX package's `perception` subpackage."""
