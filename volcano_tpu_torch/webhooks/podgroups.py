"""PodGroup admission: /podgroups/mutate — default queue
(reference: pkg/webhooks/admission/podgroups/mutate/mutate_podgroup.go:95-110).

The port's own copy of volcano_tpu/webhooks/podgroups.py.
"""

from __future__ import annotations

from ..models import objects as obj
from ..models.objects import PodGroup
from .router import AdmissionService, register_admission


def mutate_podgroup(store, operation, pg: PodGroup, old=None) -> None:
    if not pg.spec.queue:
        pg.spec.queue = obj.DEFAULT_QUEUE


register_admission(AdmissionService(
    path="/podgroups/mutate", kind="podgroups", operations=("CREATE",),
    mutate=mutate_podgroup))
