"""Core paper library: SpGEMM hypergraph models, partitioning, comm bounds
(numpy/scipy copies of ``repro.core``, pinned equal to it by the tests)."""
from repro_torch.core.hypergraph import Hypergraph, build_hypergraph_flat
from repro_torch.core.spgemm_models import (
    MODELS,
    MODELS_1D,
    MODELS_2D,
    SpGEMMInstance,
    build_model,
)
from repro_torch.core.comm import (
    CommCosts,
    classical_bound,
    evaluate,
    memory_dependent_bound,
    memory_independent_bound,
)
from repro_torch.core.partition import PartitionResult, partition

__all__ = [
    "Hypergraph",
    "build_hypergraph_flat",
    "MODELS",
    "MODELS_1D",
    "MODELS_2D",
    "SpGEMMInstance",
    "build_model",
    "CommCosts",
    "classical_bound",
    "evaluate",
    "memory_dependent_bound",
    "memory_independent_bound",
    "PartitionResult",
    "partition",
]
