"""Synthetic graph-stream generators."""
