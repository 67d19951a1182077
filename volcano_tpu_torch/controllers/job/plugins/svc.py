"""svc plugin: headless-service equivalent + hosts configmap + network policy
so a job's tasks can resolve each other (MPI/TF host lists)
(reference: pkg/controllers/job/plugins/svc/svc.go:76-313).

The port's own copy of volcano_tpu/controllers/job/plugins/svc.py.
"""

from __future__ import annotations

from typing import Dict, List

from ....models import objects as obj
from . import PluginInterface
from ...apis import make_pod_name

CONFIGMAP_MOUNT_PATH = "/etc/volcano"
CONFIGMAP_TASK_HOST_FMT = "{}.host"
ENV_TASK_HOST_FMT = "VC_{}_HOSTS"
ENV_HOST_NUM_FMT = "VC_{}_NUM"


def generate_hosts(job: obj.Job) -> Dict[str, str]:
    """Per-task host lists, one FQDN per replica (svc.go:320-345)."""
    host_file: Dict[str, str] = {}
    for ts in job.spec.tasks:
        hosts = [f"{make_pod_name(job.metadata.name, ts.name, i)}.{job.metadata.name}"
                 for i in range(ts.replicas)]
        env_key = ts.name.replace("-", "_")
        host_file[CONFIGMAP_TASK_HOST_FMT.format(env_key)] = "\n".join(hosts)
        host_file[ENV_TASK_HOST_FMT.format(env_key.upper())] = ",".join(hosts)
        host_file[ENV_HOST_NUM_FMT.format(env_key.upper())] = str(ts.replicas)
    return host_file


class SvcPlugin(PluginInterface):
    def __init__(self, store, arguments: List[str]):
        self.store = store
        self.arguments = arguments
        self.disable_network_policy = "--disable-network-policy=true" in arguments

    def name(self) -> str:
        return "svc"

    def _cm_name(self, job: obj.Job) -> str:
        return f"{job.metadata.name}-svc"

    # -- pod hook (svc.go:76-127) -----------------------------------------

    def on_pod_create(self, pod: obj.Pod, job: obj.Job) -> None:
        # values resolved from the hosts configmap (EnvVarSource
        # ConfigMapKeyRef equivalent: inline the value at create time)
        cm = self.store.get("configmaps", self._cm_name(job), job.metadata.namespace)
        host_env = {}
        for ts in job.spec.tasks:
            env_key = ts.name.replace("-", "_").upper()
            for name in (ENV_TASK_HOST_FMT.format(env_key), ENV_HOST_NUM_FMT.format(env_key)):
                host_env[name] = cm.data.get(name, "") if cm is not None else ""
        mount = {"name": self._cm_name(job), "mount_path": CONFIGMAP_MOUNT_PATH,
                 "config_map": self._cm_name(job)}
        for c in pod.spec.containers + pod.spec.init_containers:
            c.env.update(host_env)
            c.volume_mounts.append(dict(mount))

    # -- job hooks (svc.go:129-192) ----------------------------------------

    def on_job_add(self, job: obj.Job) -> None:
        if job.status.controlled_resources.get("plugin-svc") == "svc":
            return
        ns = job.metadata.namespace
        cm_name = self._cm_name(job)
        if self.store.get("configmaps", cm_name, ns) is None:
            self.store.create("configmaps", obj.ConfigMap(
                metadata=obj.ObjectMeta(
                    name=cm_name, namespace=ns,
                    owner=f"Job/{ns}/{job.metadata.name}"),
                data=generate_hosts(job)))
        if self.store.get("services", job.metadata.name, ns) is None:
            self.store.create("services", obj.Service(
                metadata=obj.ObjectMeta(
                    name=job.metadata.name, namespace=ns,
                    owner=f"Job/{ns}/{job.metadata.name}"),
                selector={obj.JOB_NAME_KEY: job.metadata.name,
                          "volcano.sh/job-namespace": ns},
                cluster_ip="None", ports=[1]))
        if not self.disable_network_policy:
            np_name = f"{job.metadata.name}-network-policy"
            if self.store.get("networkpolicies", np_name, ns) is None:
                self.store.create("networkpolicies", obj.NetworkPolicy(
                    metadata=obj.ObjectMeta(
                        name=np_name, namespace=ns,
                        owner=f"Job/{ns}/{job.metadata.name}"),
                    pod_selector={obj.JOB_NAME_KEY: job.metadata.name},
                    ingress_from_selector={obj.JOB_NAME_KEY: job.metadata.name}))
        job.status.controlled_resources["plugin-svc"] = "svc"

    def on_job_update(self, job: obj.Job) -> None:
        ns = job.metadata.namespace
        cm = self.store.get("configmaps", self._cm_name(job), ns)
        host_file = generate_hosts(job)
        if cm is None:
            self.store.create("configmaps", obj.ConfigMap(
                metadata=obj.ObjectMeta(
                    name=self._cm_name(job), namespace=ns,
                    owner=f"Job/{ns}/{job.metadata.name}"),
                data=host_file))
        elif cm.data != host_file:
            cm.data = host_file
            self.store.update("configmaps", cm, skip_admission=True)

    def on_job_delete(self, job: obj.Job) -> None:
        if job.status.controlled_resources.get("plugin-svc") != "svc":
            return
        ns = job.metadata.namespace
        for kind, name in (("services", job.metadata.name),
                           ("configmaps", self._cm_name(job)),
                           ("networkpolicies", f"{job.metadata.name}-network-policy")):
            if self.store.get(kind, name, ns) is not None:
                self.store.delete(kind, name, ns, skip_admission=True)
        job.status.controlled_resources.pop("plugin-svc", None)
