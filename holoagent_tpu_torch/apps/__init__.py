"""Counterpart of the JAX package's `apps` subpackage: model construction
(``common``), ``build_map``, the oracle accuracy protocol
(``eval_protocol``), ``eval_graph``, ``query_bench``, ``long_query_bench``
and ``serving_bench``."""
