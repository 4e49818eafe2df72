"""Geometry, sampling, grouping and segment ops, channels-last."""

from usip_tpu_torch.ops.geometry import gather_points, knn, pairwise_sqdist
from usip_tpu_torch.ops.grouping import NodeAssignment, assign_points_to_nodes
from usip_tpu_torch.ops.sampling import (farthest_point_sampling,
                                         random_subset, sample_nodes)
from usip_tpu_torch.ops.segment import (masked_scatter_max, scatter_back,
                                        segment_mean_count)

__all__ = [
    "NodeAssignment", "assign_points_to_nodes", "farthest_point_sampling",
    "gather_points", "knn", "masked_scatter_max", "pairwise_sqdist",
    "random_subset", "sample_nodes", "scatter_back", "segment_mean_count",
]
