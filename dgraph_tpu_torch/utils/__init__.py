"""Shared host infrastructure (the subset of ``dgraph_tpu.utils`` the
port uses)."""
