"""Cache-facing executor interfaces (counterpart of
volcano_tpu/cache/interface.py; reference: pkg/scheduler/cache/
interface.go:29-100): Binder, Evictor, StatusUpdater, plus the
store-backed binder, evictor and status updater, and the volume binders:
``StoreVolumeBinder``, the cache's default, binds PVCs to PVs through the
store; ``NullVolumeBinder`` counts every pod's volumes as ready.

The store is an ``ObjectStore`` or a ``RemoteStore`` (a remote apiserver's
mirror). What it offers picks the path, as in the reference: the bulk
commits (``bind_pods``, ``patch_batch``) where the store has them, one
write an object where it does not (the remote store's REST seam)."""

from __future__ import annotations

from typing import Optional, Protocol

from ..models.job_info import _fastmodel
from ..models.objects import (Pod, PodGroup, clone_pod_group_for_status)


class Binder(Protocol):
    def bind(self, pod: Pod, hostname: str) -> None: ...


class Evictor(Protocol):
    def evict(self, pod: Pod, reason: str) -> None: ...


class StatusUpdater(Protocol):
    def update_pod_condition(self, pod: Pod, reason: str, message: str) -> None: ...
    def update_pod_group(self, pg: PodGroup) -> PodGroup: ...


def bind_pods_batch(store, items, per_pod_bind, batch_ok: bool,
                    fence=None, trace=None) -> tuple:
    """Shared engine behind StoreBinder/FakeBinder ``bind_batch``: one
    ``store.bind_pods`` commit for ``[(pod, hostname)]``, or per-pod
    ``per_pod_bind`` calls when the store has no ``bind_pods`` (none, or
    a remote store) or ``batch_ok`` is False (a binder subclass overrode
    ``bind``). ``fence`` and ``trace``, when set, ride the commit (the
    leader's fencing token and the flush's correlation ID). Returns ``(failed, used_batch)``: the pairs that did
    not bind, and whether the batch path ran. The commit's request list
    is built by the native engine's ``bind_request_items`` while the
    store's NATIVE_PUBLISH is on."""
    bind_fn = getattr(store, "bind_pods", None)
    if bind_fn is None or not batch_ok:
        failed = []
        for pod, hostname in items:
            try:
                per_pod_bind(pod, hostname)
            except Exception:
                failed.append((pod, hostname))
        return failed, False
    items = items if isinstance(items, list) else list(items)
    # None from the native engine hands the list back to this body
    reqs = _fastmodel().bind_request_items(items) \
        if store.NATIVE_PUBLISH else None
    if reqs is None:
        reqs = [(pod.metadata.name, pod.metadata.namespace, hostname)
                for pod, hostname in items]
    _, missing = bind_fn(reqs, fence=fence, trace=trace)
    if not missing:
        return [], True
    gone = set(missing)
    return [(pod, hostname) for pod, hostname in items
            if (pod.metadata.name, pod.metadata.namespace) in gone], True


class StoreBinder:
    """Default binder: writes pod.spec.node_name through the object store
    (the standalone equivalent of POST .../binding, cache.go:214-230).

    ``fence`` and ``trace`` (attributes the cache sets for each write
    batch) stamp the store writes with the leader's fencing token, so a
    deposed incarnation's binds raise FencedError instead of landing
    after a takeover, and with the flush's correlation ID."""

    def __init__(self, store):
        self.store = store
        self.fence = None
        self.trace = None

    def bind(self, pod: Pod, hostname: str) -> None:
        live = self.store.get("pods", pod.metadata.name, pod.metadata.namespace)
        if live is None:
            raise KeyError(f"pod {pod.metadata.key()} not found")
        live.spec.node_name = hostname
        self.store.update("pods", live, skip_admission=True,
                          fence=self.fence, trace=self.trace)

    def bind_batch(self, items) -> list:
        """Batched bind; returns the failed [(pod, hostname)]."""
        failed, _ = bind_pods_batch(self.store, items, self.bind,
                                    type(self).bind is StoreBinder.bind,
                                    fence=self.fence, trace=self.trace)
        return failed


class StoreEvictor:
    """Default evictor: records the Evict event and deletes the pod
    through the store (cache.go:232-255)."""

    def __init__(self, store):
        self.store = store

    def evict(self, pod: Pod, reason: str) -> None:
        self.store.record_event("pods", pod, "Normal", "Evict", reason)
        self.store.delete("pods", pod.metadata.name, pod.metadata.namespace,
                          skip_admission=True)


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
            self.store.update("pods", live, skip_admission=True)

    def update_pod_conditions(self, items) -> None:
        """Bulk condition push: ``[(pod, reason, message)]`` as one
        patch_batch commit (one update a pod on a store without
        patch_batch)."""
        if not hasattr(self.store, "patch_batch"):
            for pod, reason, message in items:
                self.update_pod_condition(pod, reason, message)
            return

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
        return self.store.update("podgroups", live, skip_admission=True)

    def update_pod_groups(self, pgs) -> list:
        """Bulk status push as one patch_batch commit (one update a group
        on a store without patch_batch). Returns the new stored objects
        index-aligned with ``pgs`` (None where gone)."""
        if not hasattr(self.store, "patch_batch"):
            return [self.update_pod_group(pg) for pg in pgs]

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


class PodVolumes:
    """Planned PVC -> PV bindings of one task on one node (the reference's
    scheduling.PodVolumes, cache/interface.go:56-74)."""

    def __init__(self, bindings=None):
        # [(pvc key "ns/name", pv name)]
        self.bindings = bindings or []


class VolumeBindError(RuntimeError):
    """No PV for a claim: a RuntimeError, so the allocate action's staging
    treats it as a placement failure."""


class StoreVolumeBinder:
    """The PV/PVC flow against store objects (the reference's
    volumebinding-backed defaultVolumeBinder, cache/cache.go
    GetPodVolumes/AllocateVolumes/BindVolumes):

    * ``get_pod_volumes``: for each unbound PVC the pod mounts, the
      smallest Available PV of enough capacity, of the claim's storage
      class and reachable from the node, that no placement of this cycle
      has assumed;
    * ``allocate_volumes``: assume the planned PVs, so that two placements
      of one cycle cannot book one PV, and pods that share a claim ride
      one binding;
    * ``bind_volumes``: write PV ``claim_ref``/``phase`` and PVC
      ``volume_name``/``phase`` through the store (the API bind);
    * ``release_volumes``: drop the assumptions on a statement rollback.

    ``fence_source`` (the cache's, when the cache builds the binder) gives
    the leader's fencing token for the PV and PVC writes, as for the pod
    binds: a deposed leader's volume bind raises FencedError and leaves
    both objects as they were.
    """

    def __init__(self, store, fence_source=None):
        self.store = store
        self.fence_source = fence_source
        self._assumed: set = set()       # pv names reserved in the cycle
        self._assumed_pvc: set = set()   # pvc keys planned in the cycle

    def reset_assumptions(self) -> None:
        """Forget every assumption. The reference defines it for the
        snapshot (assumptions that never reached a bind, a kept pipelined
        gang's, would otherwise outlive the cycle) but calls it nowhere;
        neither does this port."""
        self._assumed.clear()
        self._assumed_pvc.clear()

    @staticmethod
    def _pvc_names(pod) -> list:
        names = []
        for vol in pod.spec.volumes:
            vol = vol or {}
            # k8s' {"persistentVolumeClaim": {"claimName": ...}} and the
            # job controller's {"pvc": <claim>}
            claim = vol.get("persistentVolumeClaim")
            if claim and claim.get("claimName"):
                names.append(claim["claimName"])
            elif vol.get("pvc"):
                names.append(vol["pvc"])
        return names

    def get_pod_volumes(self, task, node):
        pvc_names = self._pvc_names(task.pod)
        if not pvc_names:
            return None
        node_name = node.metadata.name if node is not None else ""
        bindings = []
        planned = set()
        for name in pvc_names:
            pvc_key = f"{task.namespace}/{name}"
            pvc = self.store.get("persistentvolumeclaims", name,
                                 task.namespace)
            if pvc is None:
                raise VolumeBindError(f"pvc {pvc_key} not found")
            if pvc.phase == "Bound" and pvc.volume_name:
                continue   # already bound: nothing to plan
            if pvc_key in self._assumed_pvc:
                # another placement of this cycle binds it; pods that
                # share the claim ride that binding
                continue
            pv_name = self._find_pv(pvc, node_name, planned)
            if pv_name is None:
                raise VolumeBindError(
                    f"no available PV for pvc {pvc_key} on node "
                    f"{node_name}")
            planned.add(pv_name)
            bindings.append((pvc_key, pv_name))
        return PodVolumes(bindings)

    def _find_pv(self, pvc, node_name: str, planned: set) -> Optional[str]:
        """The name of the smallest fitting PV (k8s' smallest fit; the
        first in store order on a tie), or None. Reads the stored PVs
        without copying them where the store lends its objects
        (``list_refs``), else a list of copies."""
        want = pvc.requested_bytes()
        cls = pvc.storage_class()
        best = None
        best_bytes = 0.0
        list_fn = getattr(self.store, "list_refs", None) or self.store.list
        for pv in list_fn("persistentvolumes"):
            name = pv.metadata.name
            if pv.phase != "Available" or pv.claim_ref:
                continue
            if name in self._assumed or name in planned:
                continue
            if cls and pv.storage_class != cls:
                continue
            if pv.node_affinity and node_name not in pv.node_affinity:
                continue
            cap = pv.capacity_bytes()
            if cap < want:
                continue
            if best is None or cap < best_bytes:
                best, best_bytes = name, cap
        return best

    def allocate_volumes(self, task, hostname, pod_volumes) -> None:
        if pod_volumes is None:
            return
        for pvc_key, pv_name in pod_volumes.bindings:
            self._assumed.add(pv_name)
            self._assumed_pvc.add(pvc_key)

    def release_volumes(self, task, pod_volumes) -> None:
        if pod_volumes is None:
            return
        for pvc_key, pv_name in pod_volumes.bindings:
            self._assumed.discard(pv_name)
            self._assumed_pvc.discard(pvc_key)

    def bind_volumes(self, task, pod_volumes) -> None:
        if pod_volumes is None:
            return
        fence = self.fence_source() if self.fence_source is not None \
            else None
        for pvc_key, pv_name in pod_volumes.bindings:
            ns, name = pvc_key.split("/", 1)
            pv = self.store.get("persistentvolumes", pv_name)
            pvc = self.store.get("persistentvolumeclaims", name, ns)
            if pv is None or pvc is None:
                continue
            pv.claim_ref = pvc_key
            pv.phase = "Bound"
            self.store.update("persistentvolumes", pv, skip_admission=True,
                              fence=fence)
            pvc.volume_name = pv_name
            pvc.phase = "Bound"
            self.store.update("persistentvolumeclaims", pvc,
                              skip_admission=True, fence=fence)
            self._assumed.discard(pv_name)
            self._assumed_pvc.discard(pvc_key)
