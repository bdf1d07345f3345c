"""Pipelines of the port: the fused windowed-embedding path and its CLI."""
