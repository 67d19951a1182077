"""Cache-facing executor interfaces (counterpart of
volcano_tpu/cache/interface.py; reference: pkg/scheduler/cache/
interface.go:29-100): Binder, Evictor, StatusUpdater, plus the
store-backed binder, evictor and status updater and the no-op volume
binder.
The PV/PVC volume binder is not ported: every pod's volumes count as
ready."""

from __future__ import annotations

from typing import Optional, Protocol

from ..models.objects import (Pod, PodGroup, clone_pod_group_for_status)


class Binder(Protocol):
    def bind(self, pod: Pod, hostname: str) -> None: ...


class Evictor(Protocol):
    def evict(self, pod: Pod, reason: str) -> None: ...


class StatusUpdater(Protocol):
    def update_pod_condition(self, pod: Pod, reason: str, message: str) -> None: ...
    def update_pod_group(self, pg: PodGroup) -> PodGroup: ...


def bind_pods_batch(store, items, per_pod_bind, batch_ok: bool) -> tuple:
    """Shared engine behind StoreBinder/FakeBinder ``bind_batch``: one
    ``store.bind_pods`` commit for ``[(pod, hostname)]``, or per-pod
    ``per_pod_bind`` calls when there is no store or ``batch_ok`` is False
    (a binder subclass overrode ``bind``). Returns ``(failed,
    used_batch)``: the pairs that did not bind, and whether the batch path
    ran."""
    if store is None or not batch_ok:
        failed = []
        for pod, hostname in items:
            try:
                per_pod_bind(pod, hostname)
            except Exception:
                failed.append((pod, hostname))
        return failed, False
    _, missing = store.bind_pods(
        [(pod.metadata.name, pod.metadata.namespace, hostname)
         for pod, hostname in items])
    if not missing:
        return [], True
    gone = set(missing)
    return [(pod, hostname) for pod, hostname in items
            if (pod.metadata.name, pod.metadata.namespace) in gone], True


class StoreBinder:
    """Default binder: writes pod.spec.node_name through the object store
    (the standalone equivalent of POST .../binding, cache.go:214-230)."""

    def __init__(self, store):
        self.store = store

    def bind(self, pod: Pod, hostname: str) -> None:
        live = self.store.get("pods", pod.metadata.name, pod.metadata.namespace)
        if live is None:
            raise KeyError(f"pod {pod.metadata.key()} not found")
        live.spec.node_name = hostname
        self.store.update("pods", live)

    def bind_batch(self, items) -> list:
        """Batched bind; returns the failed [(pod, hostname)]."""
        failed, _ = bind_pods_batch(self.store, items, self.bind,
                                    type(self).bind is StoreBinder.bind)
        return failed


class StoreEvictor:
    """Default evictor: records the Evict event and deletes the pod
    through the store (cache.go:232-255)."""

    def __init__(self, store):
        self.store = store

    def evict(self, pod: Pod, reason: str) -> None:
        self.store.record_event("pods", pod, "Normal", "Evict", reason)
        self.store.delete("pods", pod.metadata.name, pod.metadata.namespace)


class StoreStatusUpdater:
    """Default status updater: pushes pod conditions and PodGroup status
    (cache.go:257-290)."""

    def __init__(self, store):
        self.store = store

    def update_pod_condition(self, pod: Pod, reason: str, message: str) -> None:
        live = self.store.get("pods", pod.metadata.name, pod.metadata.namespace)
        if live is not None:
            live.status.reason = reason
            live.status.message = message
            self.store.update("pods", live)

    def update_pod_conditions(self, items) -> None:
        """Bulk condition push: ``[(pod, reason, message)]`` as one
        patch_batch commit."""
        def setter(reason, message):
            def fn(live):
                live.status.reason = reason
                live.status.message = message
            return fn

        self.store.patch_batch(
            "pods", [(pod.metadata.name, pod.metadata.namespace,
                      setter(reason, message))
                     for pod, reason, message in items])

    def update_pod_group(self, pg: PodGroup) -> Optional[PodGroup]:
        live = self.store.get("podgroups", pg.metadata.name, pg.metadata.namespace)
        if live is None:
            return None
        # status subresource only: the session's pg.spec is a snapshot copy
        live.status = pg.status
        return self.store.update("podgroups", live)

    def update_pod_groups(self, pgs) -> list:
        """Bulk status push as one patch_batch commit. Returns the new
        stored objects index-aligned with ``pgs`` (None where gone)."""
        def setter(status):
            def fn(live):
                live.status = status
            return fn

        pairs, missing = self.store.patch_batch(
            "podgroups", [(pg.metadata.name, pg.metadata.namespace,
                           setter(pg.status)) for pg in pgs],
            clone_fn=clone_pod_group_for_status)
        gone = set(missing)
        by_key = {(new.metadata.namespace, new.metadata.name): new
                  for _, new in pairs}
        return [None if (pg.metadata.name, pg.metadata.namespace) in gone
                else by_key.get((pg.metadata.namespace, pg.metadata.name))
                for pg in pgs]


class NullVolumeBinder:
    """No-op binder; all pods' volumes are always ready (the reference's
    FakeVolumeBinder, util/test_utils.go:160-177)."""

    def get_pod_volumes(self, task, node):
        return None

    def allocate_volumes(self, task, hostname, pod_volumes) -> None:
        return None

    def bind_volumes(self, task, pod_volumes) -> None:
        return None

    def release_volumes(self, task, pod_volumes) -> None:
        return None
