"""The cycle flight recorder (tracer), the pod lifecycle ledger (ledger),
the "why pending" diagnosis (pending) and the placement explainer
(explain); this port's own copies of volcano_tpu/trace."""

from . import ledger  # noqa: F401
from . import tracer  # noqa: F401
