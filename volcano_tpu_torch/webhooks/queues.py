"""Queue admission: /queues/validate + /queues/mutate
(reference: pkg/webhooks/admission/queues/{validate/validate_queue.go,
mutate/mutate_queue.go}).

The port's own copy of volcano_tpu/webhooks/queues.py.
"""

from __future__ import annotations

from ..models import objects as obj
from ..models.objects import Queue, QueueState
from .router import AdmissionDenied, AdmissionService, register_admission


def validate_queue(store, operation, queue: Queue, old=None) -> None:
    if operation == "DELETE":
        _validate_queue_deleting(store, old)
        return
    _validate_state(queue)
    if queue.spec.weight <= 0:
        raise AdmissionDenied("queue weight must be a positive integer")
    _validate_hierarchy(store, queue)


def _validate_state(queue: Queue) -> None:
    """validate_queue.go:170-189 — only Open/Closed may be requested."""
    state = queue.status.state
    if state and state not in (QueueState.OPEN, QueueState.CLOSED):
        raise AdmissionDenied(
            f"queue state must be in "
            f"{[QueueState.OPEN, QueueState.CLOSED]}")


def _validate_hierarchy(store, queue: Queue) -> None:
    """validate_queue.go:111-168"""
    hierarchy = queue.metadata.annotations.get(obj.QUEUE_HIERARCHY_ANNOTATION, "")
    weights = queue.metadata.annotations.get(
        obj.QUEUE_HIERARCHY_WEIGHT_ANNOTATION, "")
    if not hierarchy and not weights:
        return
    paths = hierarchy.split("/")
    weight_parts = weights.split("/")
    if len(paths) != len(weight_parts):
        raise AdmissionDenied(
            f"{obj.QUEUE_HIERARCHY_ANNOTATION} must have the same length "
            f"with {obj.QUEUE_HIERARCHY_WEIGHT_ANNOTATION}")
    for w in weight_parts:
        try:
            wf = float(w)
        except ValueError:
            raise AdmissionDenied(
                f"{w} in the {weights} is invalid number")
        if wf <= 0:
            raise AdmissionDenied(
                f"{w} in the {weights} must be larger than 0")
    # a queue must not sit on the path prefix of another queue's hierarchy
    for other in store.list("queues"):
        other_hierarchy = other.metadata.annotations.get(
            obj.QUEUE_HIERARCHY_ANNOTATION, "")
        if other_hierarchy and other.metadata.name != queue.metadata.name and \
                other_hierarchy.startswith(hierarchy):
            raise AdmissionDenied(
                f"{hierarchy} is not allowed to be in the sub path of "
                f"{other_hierarchy} of queue {other.metadata.name}")


def _validate_queue_deleting(store, queue: Queue) -> None:
    """validate_queue.go:199-214 — default queue protected; must be Closed."""
    if queue.metadata.name == "default":
        raise AdmissionDenied("`default` queue can not be deleted")
    if queue.status.state != QueueState.CLOSED:
        raise AdmissionDenied(
            f"only queue with state `{QueueState.CLOSED}` can be deleted, "
            f"queue `{queue.metadata.name}` state is `{queue.status.state}`")


def mutate_queue(store, operation, queue: Queue, old=None) -> None:
    """mutate_queue.go:99-137 — root-prefix hierarchy + weight default."""
    hierarchy = queue.metadata.annotations.get(obj.QUEUE_HIERARCHY_ANNOTATION, "")
    weights = queue.metadata.annotations.get(
        obj.QUEUE_HIERARCHY_WEIGHT_ANNOTATION, "")
    if hierarchy and weights and not hierarchy.startswith("root"):
        queue.metadata.annotations[obj.QUEUE_HIERARCHY_ANNOTATION] = \
            f"root/{hierarchy}"
        queue.metadata.annotations[obj.QUEUE_HIERARCHY_WEIGHT_ANNOTATION] = \
            f"1/{weights}"
    if queue.spec.weight == 0:
        queue.spec.weight = 1


register_admission(AdmissionService(
    path="/queues/mutate", kind="queues", operations=("CREATE",),
    mutate=mutate_queue))
register_admission(AdmissionService(
    path="/queues/validate", kind="queues",
    operations=("CREATE", "UPDATE", "DELETE"), validate=validate_queue))
