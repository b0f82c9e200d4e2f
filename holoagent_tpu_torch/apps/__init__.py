"""Counterpart of the JAX package's `apps` subpackage (so far the shared
model construction of ``apps/common.py``)."""
