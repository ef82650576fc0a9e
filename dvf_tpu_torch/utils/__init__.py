"""Image dtype helpers."""
