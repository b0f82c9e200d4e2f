"""Evaluation: GT scene graphs, HMSG accuracy metrics, segmentation metrics.

The port's own copy of the JAX package's `eval` subpackage (numpy and
scipy only), scoring the port's `memory.hmsg.HMSGraph`."""

from .gt import GTGraph, GTFloor, GTRoom, GTObject, gt_from_synthetic
from .evaluator import HMSGEvaluator
from .long_query import LongQuery, LongQueryReport, generate_long_queries, score_long_queries
