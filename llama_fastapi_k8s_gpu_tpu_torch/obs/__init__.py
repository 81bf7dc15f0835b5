"""Request traces, the metric catalog and request-id-stamped logging."""
