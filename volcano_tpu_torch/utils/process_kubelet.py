"""Process kubelet: runs bound pods as REAL OS processes.

The reference's e2e suites run real MPI/TF containers on kind-cluster
nodes (test/e2e/jobseq/mpi.go:30-81); this kubelet is the standalone
equivalent — each bound pod's first container command is spawned as an
actual subprocess with the pod's volume mounts MATERIALIZED from the
store (configmaps/secrets written to a per-pod directory, remapped under
``VOLCANO_MOUNT_ROOT``) and the container env injected. Exit code 0
marks the pod Succeeded, anything else Failed; deleting the pod kills
the process — so the job controller's failure policies act on real
process lifecycles.

The port's own copy of volcano_tpu/utils/process_kubelet.py.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
from typing import Dict, Optional, Tuple

from ..apiserver.store import ConflictError
from ..models.objects import Pod


class ProcessKubelet:
    def __init__(self, store, workdir: Optional[str] = None):
        self.store = store
        self.workdir = workdir or tempfile.mkdtemp(prefix="vc-kubelet-")
        # pod key -> (Popen, pod directory)
        self.procs: Dict[str, Tuple[subprocess.Popen, str]] = {}
        self._watches = [
            store.watch("pods", self._on_pod, lambda o, n: self._on_pod(n),
                        self._on_delete),
        ]

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        for w in self._watches:
            self.store.unwatch(w)
        self._watches = []
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        for proc, _ in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self.procs.clear()

    def _on_delete(self, pod: Pod) -> None:
        entry = self.procs.pop(pod.metadata.key(), None)
        if entry is not None and entry[0].poll() is None:
            entry[0].kill()

    # -- pod start ---------------------------------------------------------

    def _materialize_mounts(self, pod: Pod, pod_dir: str) -> None:
        """Write each container volume mount's configmap/secret content
        under ``pod_dir`` at the mount path (absolute paths remapped)."""
        ns = pod.metadata.namespace
        for c in pod.spec.containers:
            for mount in c.volume_mounts:
                target = os.path.join(
                    pod_dir, mount["mount_path"].lstrip("/"))
                os.makedirs(target, exist_ok=True)
                if mount.get("config_map"):
                    cm = self.store.get("configmaps", mount["config_map"], ns)
                    data = cm.data if cm is not None else {}
                elif mount.get("secret"):
                    sec = self.store.get("secrets", mount["secret"], ns)
                    data = sec.data if sec is not None else {}
                else:
                    continue
                for fname, content in data.items():
                    mode = "wb" if isinstance(content, bytes) else "w"
                    with open(os.path.join(target, fname), mode) as f:
                        f.write(content)

    def _on_pod(self, pod: Pod) -> None:
        if not pod.spec.node_name or pod.status.phase != "Pending":
            return
        key = pod.metadata.key()
        if key in self.procs:
            return
        live = self.store.get("pods", pod.metadata.name,
                              pod.metadata.namespace)
        if live is None or live.status.phase != "Pending":
            return
        container = live.spec.containers[0] if live.spec.containers else None
        if container is None or not container.command:
            return   # nothing to exec; the simulated kubelet's domain
        pod_dir = os.path.join(self.workdir, key.replace("/", "_"),
                               str(live.metadata.resource_version))
        os.makedirs(pod_dir, exist_ok=True)
        self._materialize_mounts(live, pod_dir)
        env = dict(os.environ)
        env.update({k: str(v) for k, v in container.env.items()})
        env["POD_NAME"] = live.metadata.name
        env["POD_NAMESPACE"] = live.metadata.namespace
        env["VOLCANO_MOUNT_ROOT"] = pod_dir
        cmd = list(container.command)
        if cmd and cmd[0] == "python":
            cmd[0] = sys.executable
        proc = subprocess.Popen(cmd, env=env, cwd=pod_dir,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        self.procs[key] = (proc, pod_dir)
        live.status.phase = "Running"
        live.status.host_ip = live.spec.node_name
        try:
            self.store.update("pods", live, skip_admission=True)
        except (ConflictError, KeyError):
            proc.kill()
            self.procs.pop(key, None)

    # -- polling / control -------------------------------------------------

    def poll(self) -> int:
        """Reap finished processes into pod phases; returns pods finished."""
        finished = 0
        for key, (proc, _) in list(self.procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            ns, name = key.split("/", 1)
            pod = self.store.get("pods", name, ns)
            if pod is None or pod.status.phase != "Running":
                del self.procs[key]   # pod gone/rewritten: nothing to record
                continue
            pod.status.exit_code = rc
            pod.status.phase = "Succeeded" if rc == 0 else "Failed"
            try:
                self.store.update("pods", pod, skip_admission=True)
            except (ConflictError, KeyError):
                continue   # raced a concurrent writer: retry next poll —
                #            dropping the entry here would lose the pod's
                #            terminal phase forever
            del self.procs[key]
            finished += 1
        return finished

    def kill(self, namespace: str, name: str,
             sig: int = signal.SIGKILL) -> bool:
        """Kill a pod's process (the e2e 'node kills a worker' event); the
        next poll() marks the pod Failed."""
        entry = self.procs.get(f"{namespace}/{name}")
        if entry is None or entry[0].poll() is not None:
            return False
        entry[0].send_signal(sig)
        return True

    def running(self) -> int:
        return sum(1 for p, _ in self.procs.values() if p.poll() is None)
