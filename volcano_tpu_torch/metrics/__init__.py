"""Prometheus-style metrics (metrics), their per-cycle time series
(timeseries) and the /metrics and /debug/* server (server); this port's
own copies of volcano_tpu/metrics."""

from . import metrics  # noqa: F401
