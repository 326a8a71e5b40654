"""Evaluation: pose-error metrics, ICP refinement and the split runner."""
