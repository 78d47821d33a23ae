"""Device compute — the matmul and selection floor of the framework.

distance: pairwise metrics, blocked/full-row kNN scans (SURVEY C4-C6 analog)
topk:     masked top-k, merges, dedup (the array heap replacement)
kmeans:   on-device Lloyd / k-means++ (PQ + IVF training)
adc:      PQ encode, distance tables, blocked ADC scans (SURVEY C7 analog)
hnsw_graph: padded-adjacency HNSW engine (SURVEY C8-C9 analog)
pool_scan: strided-bucket pool scans (large-N mode; the Triton int8 kernel)
ivf_scan: the cluster-pruned scan tier
pca:      the PCA-proxy first stage
"""

from .distance import (
    blocked_knn,
    blocked_knn_fast,
    knn_full,
    pairwise_cosine_dist,
    pairwise_dist,
    pairwise_sq_l2,
    sq_norms,
)
from .topk import merge_topk, smallest_k, unique_smallest_k

__all__ = [
    "blocked_knn",
    "blocked_knn_fast",
    "knn_full",
    "pairwise_dist",
    "pairwise_sq_l2",
    "pairwise_cosine_dist",
    "sq_norms",
    "smallest_k",
    "merge_topk",
    "unique_smallest_k",
]
