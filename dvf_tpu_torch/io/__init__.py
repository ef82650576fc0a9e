"""Frame sources and sinks."""
