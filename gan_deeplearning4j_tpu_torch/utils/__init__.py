"""Host-side utilities of the port: the artifact writer and the metrics
logger."""
