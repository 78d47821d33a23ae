"""vector_db_tpu — a vector index-and-query engine in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
Java/C++ vector database (elex-fu/vector_db): CRUD over (id, float32[dim])
vectors, k-NN under squared-L2/cosine, index types BRUTE / HNSW / HNSWPQ /
PQ / IVF / LSH / ANNOY, on-device PQ training with ADC scanning, batched
add/search, rebuild, and checkpointed persistence.
"""

from .api.config import (
    AnnoyConfig,
    CompressionConfig,
    CompressionType,
    HnswConfig,
    HnswPqConfig,
    IvfConfig,
    LshConfig,
    PqConfig,
)
from .api.database import IndexType, VectorDatabase
from .core.types import SearchResult, Vector

__version__ = "0.1.0"

__all__ = [
    "VectorDatabase",
    "IndexType",
    "Vector",
    "SearchResult",
    "CompressionConfig",
    "CompressionType",
    "HnswConfig",
    "HnswPqConfig",
    "PqConfig",
    "IvfConfig",
    "LshConfig",
    "AnnoyConfig",
    "__version__",
]
