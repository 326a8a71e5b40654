"""Pose-graph SLAM over registered keyframes (port of `pcd_reg_hregnet_tpu/slam/`)."""
from .pose_graph import (PartitionedGraph, PoseGraph, chi2, distributed_optimize, optimize,
                         partition_graph, residuals, schur_optimize)
from .sequence import build_pose_graph, icp_register_fn, model_register_fn

__all__ = ['PoseGraph', 'optimize', 'distributed_optimize', 'residuals', 'chi2',
           'PartitionedGraph', 'partition_graph', 'schur_optimize', 'build_pose_graph',
           'icp_register_fn', 'model_register_fn']
