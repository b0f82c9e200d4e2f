"""FSR query engine, fast path (counterpart of the JAX package's `query`
subpackage)."""

from .engine import FSRQueryEngine
from .parser import ParsedQuery, RuleParser
from .vlm_backend import NullVLM, VLMBackend
