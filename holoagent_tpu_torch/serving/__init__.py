"""On-slice model serving with continuous batching (counterpart of the JAX
package's `serving` subpackage)."""

from .batcher import ContinuousBatcher, GenRequest
