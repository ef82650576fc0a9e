"""Streaming metrics."""
