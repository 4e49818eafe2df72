"""Geometry, sampling, grouping and segment ops, channels-last."""

from usip_tpu_torch.ops.geometry import (gather_points, knn, pairwise_dist,
                                         pairwise_sqdist)
from usip_tpu_torch.ops.grouping import (BallQueryResult, NodeAssignment,
                                         assign_points_to_nodes, ball_query)
from usip_tpu_torch.ops.sampling import (farthest_point_sampling,
                                         random_subset, sample_nodes)
from usip_tpu_torch.ops.segment import (masked_scatter_max, scatter_back,
                                        segment_mean_count)
from usip_tpu_torch.ops.topk import smallest_k

__all__ = [
    "BallQueryResult", "NodeAssignment", "assign_points_to_nodes",
    "ball_query", "farthest_point_sampling", "gather_points", "knn",
    "masked_scatter_max", "pairwise_dist", "pairwise_sqdist",
    "random_subset", "sample_nodes", "scatter_back", "segment_mean_count",
    "smallest_k",
]
