"""Pose-based image retrieval (port of ``stlpose_tpu/retrieval``):
pose-vector processing, the native HNSW kNN index, neighbour search with
penalisation, and retrieval metrics. Host numpy code, as in the JAX
package."""

from stlpose_tpu_torch.retrieval.hnsw import Index
from stlpose_tpu_torch.retrieval.pose_db import (
    process_pose_vector, process_data, create_graph, load_knn,
    save_knn_structure, load_database, save_database, get_neighbors_idxs,
)
from stlpose_tpu_torch.retrieval.metrics import (score_retrievals,
                                                 confidence_score, oks_score)
