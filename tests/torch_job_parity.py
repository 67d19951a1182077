"""The job path of both packages side by side: what the port's control
plane (its Job kinds, admission, controllers and kubelet) leaves in its
store, held against what the reference's leaves, on the same inputs.

* ``Recorder`` records, while it is installed, every ObjectStore a
  package creates and every admission review that store runs (the
  verdict, and the object as the mutating hooks left it).
  ``hold_case`` runs one reference test case on each package under a
  recorder and asserts that the two left the same things: the comparable
  projection of every store (``store_digest``) and every verdict.
* ``Plane`` is the in-process control plane of cmd/cluster.py's
  ``build_cluster`` on a FakeClock (the port's own ``build_cluster``; the
  reference's built by hand in the same order, since its has no clock),
  and ``pump`` drives it as tests/test_controllers.py's ``converge``
  does: the controllers' sync, one scheduling cycle, the commit's flush
  and a kubelet tick a round.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import re
import time
from typing import Dict, List, Optional

import numpy as np

PORT = "volcano_tpu_torch"
REFERENCE = "volcano_tpu"

# fields that differ between two runs of one package: the store's uids
# come from a process-wide counter, a condition's transition id is a
# random uuid, and timestamps come from the clock where a
# test runs on the real one
VOLATILE = frozenset({"uid", "transition_id", "resource_version",
                      "creation_timestamp",
                      "deletion_timestamp", "last_transition_time"})
# the kinds of the job path whose objects are compared
DIGEST_KINDS = ("jobs", "podgroups", "pods", "queues", "commands",
                "services", "configmaps", "secrets", "networkpolicies",
                "persistentvolumeclaims")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def scrub(value):
    """A codec-encoded object without its VOLATILE fields."""
    if isinstance(value, dict):
        return {k: scrub(v) for k, v in value.items() if k not in VOLATILE}
    if isinstance(value, list):
        return [scrub(v) for v in value]
    return value


def encode(pkg: str, kind: str, o) -> dict:
    """The comparable form of one object: codec-encoded without its
    VOLATILE fields; a Secret keeps only its keys (the ssh plugin's
    keypair is random in both packages), and a Command's name drops the
    wall-clock milliseconds vcctl appends to it."""
    enc = scrub(mod(pkg, "apiserver.codec").encode(o))
    if kind == "secrets":
        enc["data"] = sorted(enc["data"])
    elif kind == "commands":
        enc["metadata"]["name"] = re.sub(r"-\d+$", "-<ms>",
                                         enc["metadata"]["name"])
    return enc


def store_digest(pkg: str, store) -> Dict[str, list]:
    """The comparable projection of a store: every object of DIGEST_KINDS
    in key order, in its comparable form (``encode``)."""
    out = {}
    for kind in DIGEST_KINDS:
        objs = sorted(store.list(kind), key=lambda o: (
            o.metadata.namespace, o.metadata.name))
        out[kind] = [encode(pkg, kind, o) for o in objs]
    return out


class Recorder:
    """Records the stores a package creates and the admission reviews
    they run, while installed."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.stores: list = []
        self.reviews: list = []

    def __enter__(self):
        cls = mod(self.pkg, "apiserver.store").ObjectStore
        self._cls = cls
        self._init, self._admit = cls.__init__, cls._admit
        init, admit, rec = self._init, self._admit, self

        def recorded_init(store, *a, **kw):
            init(store, *a, **kw)
            rec.stores.append(store)

        def recorded_admit(store, kind, operation, new_obj, old_obj=None):
            named = old_obj if new_obj is None else new_obj
            name = encode(rec.pkg, kind, named)["metadata"]["name"]
            try:
                admit(store, kind, operation, new_obj, old_obj)
            except Exception as e:
                rec.reviews.append((kind, operation, name,
                                    type(e).__name__, str(e)))
                raise
            rec.reviews.append((kind, operation, name, "allowed",
                                encode(rec.pkg, kind, new_obj)
                                if new_obj is not None else None))
        cls.__init__, cls._admit = recorded_init, recorded_admit
        return self

    def __exit__(self, *exc):
        self._cls.__init__, self._cls._admit = self._init, self._admit

    def result(self) -> dict:
        return {"stores": [store_digest(self.pkg, s) for s in self.stores],
                "reviews": self.reviews}


def run_case(module, case: str) -> None:
    """Run ``Class::method`` (or ``function``) of a test module."""
    if "::" in case:
        cls_name, meth = case.split("::")
        getattr(getattr(module, cls_name)(), meth)()
    else:
        getattr(module, case)()


def case_names(module, classes) -> List[str]:
    return [f"{c}::{m}" for c in classes
            for m in sorted(vars(getattr(module, c)))
            if m.startswith("test_")]


def hold_case(ref_module, port_module, case: str) -> None:
    """The reference case and its port run each under a recorder: the
    stores they left and the admission verdicts they met must be equal."""
    with Recorder(REFERENCE) as ref:
        run_case(ref_module, case)
    with Recorder(PORT) as port:
        run_case(port_module, case)
    want, got = ref.result(), port.result()
    assert len(got["stores"]) == len(want["stores"]), case
    for i, (a, b) in enumerate(zip(got["stores"], want["stores"])):
        for kind in DIGEST_KINDS:
            assert a[kind] == b[kind], (case, i, kind)
    assert got["reviews"] == want["reviews"], case


# -- the control plane, driven round by round --------------------------------


def vcjob(pkg: str, name: str, replicas: int, min_available: int,
          cpu: str = "2", memory: str = "4Gi", queue: str = "default",
          namespace: str = "default", **spec_kw):
    """A vcjob of one task (``main``) as ``vcctl job run`` builds it."""
    o = mod(pkg, "models.objects")
    return o.Job(
        metadata=o.ObjectMeta(name=name, namespace=namespace),
        spec=o.JobSpec(
            min_available=min_available, queue=queue,
            tasks=[o.TaskSpec(
                name="main", replicas=replicas,
                template=o.PodTemplate(
                    metadata=o.ObjectMeta(name="main"),
                    spec=o.PodSpec(containers=[o.Container(
                        name="main",
                        requests={"cpu": cpu, "memory": memory})])))],
            **spec_kw))


class Plane:
    """cmd/cluster.py's in-process control plane of one package on a
    FakeClock: store with admission, the default queue, ``n_nodes`` nodes
    of ``node_resources``, the controller manager, the simulated kubelet
    and the scheduler (the port's on ``device``) under its default conf,
    nothing started but the scheduler cache's ingestion."""

    def __init__(self, pkg: str, n_nodes: int, node_resources: str,
                 device: str = "cpu"):
        self.pkg = pkg
        clock = mod(pkg, "utils.clock").FakeClock(start=100.0)
        if pkg == PORT:
            cluster = mod(pkg, "cmd.cluster")
            (self.store, self.manager, self.kubelet, self.scheduler,
             server) = cluster.build_cluster(
                port=0, nodes=n_nodes, node_resources=node_resources,
                clock=clock, device=device)
            server.httpd.server_close()
        else:
            self.store = mod(pkg, "apiserver.store").ObjectStore(clock=clock)
            mod(pkg, "webhooks").WebhookManager(self.store)
            o = mod(pkg, "models.objects")
            self.store.create("queues", o.Queue(
                metadata=o.ObjectMeta(name="default"),
                spec=o.QueueSpec(weight=1)), skip_admission=True)
            res = mod(pkg, "cli.util").parse_resource_list(node_resources)
            build_node = mod(pkg, "utils.test_utils").build_node
            for i in range(n_nodes):
                self.store.create("nodes", build_node(f"node-{i}", res))
            self.manager = mod(pkg, "controllers").ControllerManager(
                self.store)
            self.kubelet = mod(pkg, "utils.kubelet").SimulatedKubelet(
                self.store)
            self.scheduler = mod(pkg, "scheduler").Scheduler(self.store)
        self.clock = clock
        self.scheduler.cache.run()

    def submit(self, jobs) -> None:
        for job in jobs:
            self.store.create("jobs", job)

    def round(self) -> Dict[str, float]:
        """One round of the pump; the seconds of each of its steps."""
        t = [time.perf_counter()]
        self.manager.sync()
        t.append(time.perf_counter())
        self.scheduler.run_once()
        t.append(time.perf_counter())
        self.scheduler.cache.flush_executors()
        t.append(time.perf_counter())
        self.kubelet.tick()
        t.append(time.perf_counter())
        return {k: t[i + 1] - t[i] for i, k in enumerate(
            ("sync_s", "cycle_s", "flush_s", "tick_s"))}

    def close(self) -> None:
        self.scheduler.cache.stop()


def all_running(store) -> bool:
    jobs = store.list("jobs")
    return bool(jobs) and all(j.status.state.phase == "Running"
                              for j in jobs)


def pump(plane: Plane, max_rounds: int = 8, until=all_running) -> list:
    """Rounds until ``until(store)``; fails past ``max_rounds``. Returns
    each round's seconds and the job phases after it."""
    rounds = []
    for _ in range(max_rounds):
        r = plane.round()
        r["phases"] = job_phases(plane.store)
        rounds.append(r)
        if until(plane.store):
            return rounds
    raise AssertionError(f"not converged in {max_rounds} rounds: "
                         f"{rounds[-1]['phases']}")


def job_phases(store) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for j in store.list("jobs"):
        out[j.status.state.phase] = out.get(j.status.state.phase, 0) + 1
    return dict(sorted(out.items()))


def binds(store) -> Dict[str, str]:
    return {p.metadata.key(): p.spec.node_name for p in store.list("pods")
            if p.spec.node_name}


def bind_fingerprint(store) -> str:
    """sha256 over the sorted ``namespace/pod->node`` lines of the
    store's bound pods."""
    h = hashlib.sha256()
    for key, node in sorted(binds(store).items()):
        h.update(f"{key}->{node}\n".encode())
    return h.hexdigest()


# -- the vcjob north star and its record -------------------------------------

# the shape of chip_smoke's jobs (a): the north star's nodes
# (utils/synth.py:populate_store) and 6,250 vcjobs of 8 with its requests
JOBS_SHAPE = {"nodes": 10_000, "node_resources": "cpu=64,memory=256Gi,pods=110",
              "jobs": 6_250, "replicas": 8, "cpu": "2", "memory": "4Gi",
              "max_rounds": 8}


def vcjob_name(i: int) -> str:
    return f"vj-{i:05d}"


def run_jobs_shape(pkg: str, shape: dict, device: str = "cpu") -> dict:
    """The pump at ``shape``: every vcjob submitted through admission,
    then rounds until every job is Running. Returns the record's facts:
    rounds, binds, jobs and PodGroups Running, the queue's counts and the
    bind fingerprint."""
    plane = Plane(pkg, shape["nodes"], shape["node_resources"], device)
    try:
        plane.submit(vcjob(pkg, vcjob_name(i), shape["replicas"],
                           shape["replicas"], shape["cpu"], shape["memory"])
                     for i in range(shape["jobs"]))
        rounds = pump(plane, shape["max_rounds"])
        return jobs_facts(plane.store, rounds)
    finally:
        plane.close()


def jobs_facts(store, rounds) -> dict:
    pgs = store.list("podgroups")
    q = store.get("queues", "default")
    return {"rounds": len(rounds),
            "phases_by_round": [r["phases"] for r in rounds],
            "binds": len(binds(store)),
            "pods_running": sum(p.status.phase == "Running"
                                for p in store.list("pods")),
            "podgroups_running": sum(g.status.phase == "Running"
                                     for g in pgs),
            "queue_running": q.status.running, "queue_pending":
            q.status.pending, "queue_inqueue": q.status.inqueue,
            "bind": bind_fingerprint(store)}


def mix_jobs(pkg: str, seed: int, n: int) -> list:
    """A seeded mix of vcjob shapes over three queues: replicas 1-6,
    minAvailable up to the replicas, requests of 1-4 CPUs, a job-level
    PodFailed -> RestartJob policy on every third and a TTL after
    finished on every fourth."""
    rng = np.random.default_rng(seed)
    o = mod(pkg, "models.objects")
    jobs = []
    for i in range(n):
        replicas = int(rng.integers(1, 7))
        kw = {}
        if i % 3 == 0:
            kw["policies"] = [o.LifecyclePolicy(
                event=o.JobEvent.POD_FAILED, action=o.JobAction.RESTART_JOB)]
        if i % 4 == 0:
            kw["ttl_seconds_after_finished"] = 5
        jobs.append(vcjob(
            pkg, f"mix-{i:03d}", replicas, int(rng.integers(1, replicas + 1)),
            cpu=str(int(rng.integers(1, 5))), memory="1Gi",
            queue=("default", "q1", "q2")[i % 3], **kw))
    return jobs


@contextlib.contextmanager
def planes(n_nodes: int, node_resources: str):
    """A Plane of each package, closed on the way out."""
    ref = Plane(REFERENCE, n_nodes, node_resources)
    port = Plane(PORT, n_nodes, node_resources)
    try:
        yield ref, port
    finally:
        ref.close()
        port.close()


def queue(pkg: str, name: str, weight: int):
    o = mod(pkg, "models.objects")
    return o.Queue(metadata=o.ObjectMeta(name=name),
                   spec=o.QueueSpec(weight=weight))


def command(pkg: str, name: str, job: str, action: str):
    o = mod(pkg, "models.objects")
    return o.Command(metadata=o.ObjectMeta(name=name), action=action,
                     target_name=job)


def finish_pods(plane: Plane, job: str, n: Optional[int] = None,
                exit_code: int = 0) -> None:
    """The kubelet finishes the Running pods of ``job`` (the first ``n``
    by name, all by default) with ``exit_code``."""
    pods = sorted((p for p in plane.store.list("pods")
                   if p.metadata.name.startswith(job + "-")
                   and p.status.phase == "Running"),
                  key=lambda p: p.metadata.name)
    for p in pods[:n]:
        plane.kubelet.complete(p.metadata.namespace, p.metadata.name,
                               exit_code)
