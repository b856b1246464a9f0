"""annchor_tpu: accelerator-native approximate k-NN graphs for slow metrics.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the
ANNchor algorithm family (anchor-based k-NN graph construction that
minimises calls to an expensive metric), plus batched device metric
kernels, exact native optimal transport, and multi-device sharding of
the pair pipeline.
"""

import os as _os
from pathlib import Path as _Path

# Persistent XLA compile cache.  When JAX_COMPILATION_CACHE_DIR is set
# JAX reads it itself and nothing is set here.  Otherwise the cache
# lives at one fixed path inside the checkout (<repo>/.cache/jax,
# git-ignored): the path is part of the cache key, so it must not move
# between processes.  CPU-only processes (the tests) skip the default:
# XLA:CPU entries reload badly across hosts and CPU compiles are cheap.
DEFAULT_CACHE_DIR = str(_Path(__file__).resolve().parent.parent / ".cache" / "jax")


def _configure_compile_cache():
    if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
        return None
    if _os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return DEFAULT_CACHE_DIR


_configure_compile_cache()

from annchor_tpu.annchor import Annchor, BruteForce, compare_neighbor_graphs
from annchor_tpu.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu.exact import exact_knn, exact_query_rows, exact_rows
from annchor_tpu.graph_sp import GraphShortestPathMetric
from annchor_tpu.metrics import Metric, get_function_from_input
from annchor_tpu.pickers import (
    ExternalAnchorPicker,
    MaxMinAnchorPicker,
    RandomAnchorPicker,
    SelectedAnchorPicker,
)
from annchor_tpu.regressors import SimpleStratifiedLinearRegression
from annchor_tpu.samplers import (
    ClusterSampler,
    NothingToSample,
    Sampler,
    SimpleStratifiedSampler,
)

__version__ = "0.1.0"

__all__ = [
    "Annchor",
    "BruteForce",
    "compare_neighbor_graphs",
    "Metric",
    "get_function_from_input",
    "GraphShortestPathMetric",
    "MaxMinAnchorPicker",
    "RandomAnchorPicker",
    "SelectedAnchorPicker",
    "ExternalAnchorPicker",
    "Sampler",
    "SimpleStratifiedSampler",
    "ClusterSampler",
    "NothingToSample",
    "SimpleStratifiedLinearRegression",
    "SimpleStratifiedErrorRegression",
    "exact_knn",
    "exact_rows",
    "exact_query_rows",
]
