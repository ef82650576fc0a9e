"""Host ms per batch in the pipeline's ingest (staging, H2D puts and the
depth-window waits), from the port's ``IngestStats`` over the window."""


def read(outcome):
    return outcome.get("ingest_ms_per_batch")
