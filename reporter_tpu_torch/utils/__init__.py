"""Host-side utilities of the serving front-end: locks, metrics, span
tracing and the read-ahead worker."""
