"""Simulated kubelet: drives bound pods through their phase lifecycle.

The reference delegates pod execution to real kubelets; this standalone
framework provides a simulator so end-to-end tests and the simulation harness
can run jobs to completion (the analogue of the reference's kind-cluster e2e
environment, SURVEY.md section 4.3 — containerized nodes, no real cluster).

Pods annotated with ``volcano.sh/sim-duration`` run for that many clock
seconds then Succeed (or Fail when ``volcano.sh/sim-exit-code`` is nonzero).
Without the annotation pods run until completed explicitly.

The port's own copy of volcano_tpu/utils/kubelet.py.
"""

from __future__ import annotations

import heapq
from typing import List, Set, Tuple

from ..apiserver.store import ConflictError
from ..models.objects import Pod

SIM_DURATION_KEY = "volcano.sh/sim-duration"
SIM_EXIT_CODE_KEY = "volcano.sh/sim-exit-code"


class SimulatedKubelet:
    def __init__(self, store):
        self.store = store
        self._timers: List[Tuple[float, str]] = []
        self._running: Set[str] = set()
        self._watches = [
            store.watch("pods", self._on_pod, lambda o, n: self._on_pod(n),
                        self._on_delete),
        ]

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []

    def _on_delete(self, pod: Pod) -> None:
        # a restarted job recreates pods under the same names; forget the old
        # incarnation or the new pod would never start
        self._running.discard(pod.metadata.key())

    def _on_pod(self, pod: Pod) -> None:
        """Bound + Pending -> start running."""
        if not pod.spec.node_name or pod.status.phase != "Pending":
            return
        key = pod.metadata.key()
        if key in self._running:
            return
        self._running.add(key)
        # watch payloads are the store's live objects and must not be mutated;
        # round-trip through get (a copy) so watchers observe the phase edge
        live = self.store.get("pods", pod.metadata.name, pod.metadata.namespace)
        if live is None or live.status.phase != "Pending":
            return
        live.status.phase = "Running"
        live.status.host_ip = live.spec.node_name
        try:
            self.store.update("pods", live, skip_admission=True)
        except (ConflictError, KeyError):
            # raced the job controller updating/deleting this pod; the watch
            # redelivers the fresh object and we restart it then
            self._running.discard(key)
            return
        duration = pod.metadata.annotations.get(SIM_DURATION_KEY)
        if duration is not None:
            due = self.store.clock.now() + float(duration)
            heapq.heappush(self._timers, (due, key))

    def tick(self) -> int:
        """Finish pods whose sim duration elapsed; returns pods finished."""
        now = self.store.clock.now()
        finished = 0
        retries = []
        while self._timers and self._timers[0][0] <= now:
            _, key = heapq.heappop(self._timers)
            ns, name = key.split("/", 1)
            pod = self.store.get("pods", name, ns)
            self._running.discard(key)
            if pod is None or pod.status.phase != "Running":
                continue
            exit_code = int(pod.metadata.annotations.get(SIM_EXIT_CODE_KEY, "0"))
            pod.status.exit_code = exit_code
            pod.status.phase = "Succeeded" if exit_code == 0 else "Failed"
            try:
                self.store.update("pods", pod, skip_admission=True)
            except (ConflictError, KeyError):
                # pod deleted or rewritten mid-completion (e.g. job restart);
                # requeue AFTER the drain loop so the retry happens on the
                # next tick against the fresh object, not a same-tick spin
                retries.append(key)
                continue
            finished += 1
        for key in retries:
            heapq.heappush(self._timers, (now, key))
        return finished

    def complete(self, namespace: str, name: str, exit_code: int = 0) -> None:
        """Explicitly finish a running pod (e2e helper)."""
        pod = self.store.get("pods", name, namespace)
        if pod is None:
            return
        pod.status.exit_code = exit_code
        pod.status.phase = "Succeeded" if exit_code == 0 else "Failed"
        self._running.discard(pod.metadata.key())
        self.store.update("pods", pod, skip_admission=True)
