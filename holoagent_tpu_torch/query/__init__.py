"""FSR query engine: fast hierarchical CLIP retrieval + slow VLM refinement
(counterpart of the JAX package's `query` subpackage)."""

from .engine import FSRQueryEngine
from .oracle import OracleVLM, read_tag, tag_image
from .parser import LLMParser, ParsedQuery, RuleParser
from .vlm_backend import ClipVLM, GenerativeVLM, NullVLM, VLMBackend
