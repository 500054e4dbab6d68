"""Typed query batches and the batched query planner."""
