"""Host-side scheduling: drop-oldest ingest queue and reorder buffer."""
