"""The port's command-line tools (volcano_tpu_torch/cli: vcctl's job and
queue verbs, the single-verb tools) and the job kinds on the port's codec,
HTTP wire and write-ahead log, held against the JAX package's.

* The cases of tests/test_cli.py run on the port (``port_cases``):
  TestCodec, TestVcctlJob, TestVcctlQueue, TestSingleVerbTools,
  TestHTTPServer and TestVersion.
* The cases that work on a store (the ``store`` fixture) also run on both
  packages under a recorder (tests/torch_job_parity.py): the stores they
  left and every admission verdict must be equal.
* The job kinds (jobs, commands, services, secrets, networkpolicies)
  encode to the same bytes in both packages, on the native encoder (which
  hands none of them back to the Python body) and the Python one, and
  each package decodes the other's.
* Across the packages: a Job written by each package's StoreClient to the
  other package's apiserver is admitted there and reads back equal; a
  data directory of job-path objects written through each package's
  write-ahead log recovers in the other to the same objects.

Tolerance: exact.
"""

import json

import pytest

from tests import test_cli as ref_cli_tests
from tests import torch_job_parity as tp
from tests.torch_reference_cases import port_cases

# the port's version line names the port
_cli = port_cases("test_cli", replace=[(
    '"volcano-tpu version" in out', '"volcano-tpu-torch version" in out')])

store = _cli.store
TestCodec = _cli.TestCodec
TestVcctlJob = _cli.TestVcctlJob
TestVcctlQueue = _cli.TestVcctlQueue
TestSingleVerbTools = _cli.TestSingleVerbTools
TestHTTPServer = _cli.TestHTTPServer
TestVersion = _cli.TestVersion

STORE_CLASSES = ("TestVcctlJob", "TestVcctlQueue", "TestSingleVerbTools")


def admitted_store(pkg: str):
    """What tests/test_cli.py's ``store`` fixture builds, in ``pkg``."""
    s = tp.mod(pkg, "apiserver.store").ObjectStore()
    tp.mod(pkg, "webhooks").WebhookManager(s)
    s.create("queues", tp.mod(pkg, "utils.test_utils").build_queue(
        "default"), skip_admission=True)
    return s


def test_every_reference_case_is_ported():
    assert len(tp.case_names(ref_cli_tests, STORE_CLASSES)) == 12


@pytest.mark.parametrize("case", tp.case_names(ref_cli_tests, STORE_CLASSES))
def test_store_case_matches_reference(case):
    cls, meth = case.split("::")
    results = {}
    for pkg, module in ((tp.REFERENCE, ref_cli_tests), (tp.PORT, _cli)):
        with tp.Recorder(pkg) as rec:
            getattr(getattr(module, cls)(), meth)(admitted_store(pkg))
        results[pkg] = rec.result()
    assert results[tp.PORT] == results[tp.REFERENCE]


def job_kinds(pkg: str) -> dict:
    """One object of each job kind, as the job controller and its plugins
    write them (a Job after admission's defaults, with a status)."""
    o = tp.mod(pkg, "models.objects")
    job = tp.vcjob(pkg, "j1", 3, 2, policies=[o.LifecyclePolicy(
        event=o.JobEvent.POD_FAILED, action=o.JobAction.RESTART_JOB)],
        plugins={"ssh": [], "svc": ["--disable-network-policy=false"]},
        ttl_seconds_after_finished=30, volumes=[{"mount_path": "/data"}])
    job.spec.tasks[0].policies = [o.LifecyclePolicy(exit_code=3,
                                                    action="RestartTask")]
    job.status.state.phase = o.JobPhase.RUNNING
    job.status.task_status_count = {"main": {"Running": 3}}
    job.status.controlled_resources = {"plugin-ssh": "ssh"}
    meta = o.ObjectMeta
    return {
        "jobs": job,
        "commands": o.Command(metadata=meta(name="j1-abortjob-1"),
                              action=o.JobAction.ABORT_JOB,
                              target_name="j1", reason="user"),
        "services": o.Service(metadata=meta(name="j1", owner="Job/default/j1"),
                              selector={"volcano.sh/job-name": "j1"},
                              ports=[22]),
        "secrets": o.Secret(metadata=meta(name="j1-ssh"),
                            data={"id_rsa": b"\x00\xffkey",
                                  "config": b"Host *"}),
        "networkpolicies": o.NetworkPolicy(
            metadata=meta(name="j1"),
            pod_selector={"volcano.sh/job-name": "j1"},
            ingress_from_selector={"volcano.sh/job-name": "j1"}),
    }


@pytest.mark.parametrize("kind", ["jobs", "commands", "services", "secrets",
                                  "networkpolicies"])
@pytest.mark.parametrize("native", [True, False])
def test_job_kinds_encode_alike(kind, native, monkeypatch):
    port_codec = tp.mod(tp.PORT, "apiserver.codec")
    ref_codec = tp.mod(tp.REFERENCE, "apiserver.codec")
    monkeypatch.setattr(port_codec, "NATIVE_ENCODE", native)
    port_obj = job_kinds(tp.PORT)[kind]
    ref_obj = job_kinds(tp.REFERENCE)[kind]
    handbacks = port_codec.encode_handbacks
    got = port_codec.dumps_compact(port_obj)
    # the native encoder knows every shape of the job kinds
    assert port_codec.encode_handbacks == handbacks
    want = json.dumps(ref_codec.encode_object(kind, ref_obj),
                      separators=(",", ":")).encode()
    assert got == want
    back = port_codec.decode_object(kind, json.loads(want))
    assert back == port_obj
    ref_back = ref_codec.decode_object(kind, json.loads(got))
    assert ref_back == ref_obj
    assert kind in tp.mod(tp.PORT, "apiserver.store").NAMESPACED


def _server(pkg: str):
    http = tp.mod(pkg, "apiserver.http")
    s = admitted_store(pkg)
    server = http.StoreHTTPServer(s, port=0)
    server.start()
    return s, server


@pytest.mark.parametrize("client_pkg,server_pkg", [
    (tp.PORT, tp.REFERENCE), (tp.REFERENCE, tp.PORT)])
def test_store_client_writes_jobs_to_the_other_apiserver(client_pkg,
                                                        server_pkg):
    """A Job from one package's StoreClient to the other's apiserver:
    admitted there (its defaults applied, an invalid one refused with
    422), read back equal through both packages' clients."""
    s, server = _server(server_pkg)
    try:
        url = f"http://127.0.0.1:{server.port}"
        client = tp.mod(client_pkg, "apiserver.http").StoreClient(url)
        job = tp.vcjob(client_pkg, "cross", 4, 0)
        client.create("jobs", job)
        bad = tp.vcjob(client_pkg, "bad", 2, 5)
        with pytest.raises(tp.mod(client_pkg, "apiserver.http").ApiError) \
                as exc:
            client.create("jobs", bad)
        assert exc.value.code == 422
        back = client.get("jobs", "cross")
        assert back.spec.min_available == 4      # the mutating hook's
        assert back.spec.scheduler_name == "volcano"
        other = tp.mod(server_pkg, "apiserver.http").StoreClient(url)
        assert tp.encode(client_pkg, "jobs", back) == \
            tp.encode(server_pkg, "jobs", other.get("jobs", "cross")) == \
            tp.encode(server_pkg, "jobs", s.get("jobs", "cross"))
        cmd = tp.command(client_pkg, "cross-abort", "cross", "AbortJob")
        client.create("commands", cmd)
        assert [c.metadata.name for c in other.list("commands")] == \
            ["cross-abort"]
    finally:
        server.stop()


def _write_job_path(pkg: str, data_dir: str):
    """Jobs through admission and the controllers (PodGroups, pods, the
    ssh Secret, the svc Service, ConfigMap and NetworkPolicy) in a store
    whose write-ahead log is ``data_dir``; returns the store."""
    s = tp.mod(pkg, "apiserver.store").ObjectStore()
    wal = tp.mod(pkg, "apiserver.wal").WriteAheadLog(data_dir)
    wal.attach(s)
    tp.mod(pkg, "webhooks").WebhookManager(s)
    s.create("queues", tp.mod(pkg, "utils.test_utils").build_queue(
        "default"), skip_admission=True)
    s.create("nodes", tp.mod(pkg, "utils.test_utils").build_node(
        "n1", {"cpu": "8", "memory": "16Gi"}))
    manager = tp.mod(pkg, "controllers").ControllerManager(s)
    s.create("jobs", tp.vcjob(pkg, "mpi", 2, 2,
                              plugins={"ssh": [], "svc": []}))
    s.create("jobs", tp.vcjob(pkg, "plain", 1, 1))
    manager.sync()
    s.create("commands", tp.command(pkg, "plain-abort", "plain",
                                    "AbortJob"))
    wal.pump()
    wal.close()
    return s


@pytest.mark.parametrize("writer,reader", [
    (tp.PORT, tp.REFERENCE), (tp.REFERENCE, tp.PORT)])
def test_data_directory_recovers_in_the_other_package(writer, reader,
                                                      tmp_path):
    live = _write_job_path(writer, str(tmp_path))
    rec, _ = tp.mod(reader, "apiserver.wal").recover_store(str(tmp_path))
    assert rec.current_rv() == live.current_rv()
    kinds = tp.DIGEST_KINDS + ("nodes",)
    for kind in kinds:
        got = sorted((o.metadata.namespace, o.metadata.name,
                      o.metadata.resource_version,
                      tp.mod(reader, "apiserver.codec").encode(o))
                     for o in rec.list(kind))
        want = sorted((o.metadata.namespace, o.metadata.name,
                       o.metadata.resource_version,
                       tp.mod(writer, "apiserver.codec").encode(o))
                      for o in live.list(kind))
        assert got == want, kind
    assert [len(rec.list(k)) for k in ("jobs", "secrets", "services",
                                       "networkpolicies", "commands")] == \
        [2, 1, 1, 1, 1]
