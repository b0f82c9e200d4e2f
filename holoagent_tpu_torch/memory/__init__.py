"""Counterpart of the JAX package's `memory` subpackage."""
