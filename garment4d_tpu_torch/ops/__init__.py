"""Geometry primitives: plain torch versions and hand-written CUDA kernels."""

from garment4d_tpu_torch.ops._build import launch_counts, reset_counts
from garment4d_tpu_torch.ops.graph import (
    bandwidth_permutation,
    build_mesh_adjacency,
    cyclic_diagonals,
    gcn_adjacency,
    gcn_stack,
    graph_matmul,
    graph_matmul_banded,
    laplacian_adjacency,
    row_normalize,
    smoothing_operator,
)
from garment4d_tpu_torch.ops.meshmath import (
    cot_laplacian_apply,
    cotangent_weights,
    face_normals,
    vertex_normals,
)
from garment4d_tpu_torch.ops.pemax import (
    group_chain_max,
    group_pe_max,
    group_pe_max_split_frozen,
    query_group_pe_multi,
)
from garment4d_tpu_torch.ops.pointcloud import (
    ball_query,
    ball_query_multi,
    covered_mask,
    furthest_point_sample,
    gather_points,
    group_all,
    group_points,
    interp_weights_from_dists,
    knn_points,
    pairwise_sqdist,
    plain_ops,
    query_and_group,
    scatter_add_rows,
    three_interpolate,
    three_nn,
    use_kernel,
)

__all__ = [
    "ball_query", "ball_query_multi", "bandwidth_permutation",
    "build_mesh_adjacency", "cot_laplacian_apply", "cotangent_weights",
    "covered_mask", "cyclic_diagonals",
    "face_normals", "furthest_point_sample", "gather_points",
    "gcn_adjacency", "gcn_stack", "graph_matmul", "graph_matmul_banded",
    "group_all", "group_chain_max", "group_pe_max",
    "group_pe_max_split_frozen", "group_points",
    "interp_weights_from_dists", "knn_points", "laplacian_adjacency",
    "launch_counts",
    "pairwise_sqdist", "plain_ops", "query_and_group",
    "query_group_pe_multi", "reset_counts", "row_normalize", "scatter_add_rows",
    "smoothing_operator", "three_interpolate", "three_nn", "use_kernel",
    "vertex_normals",
]
