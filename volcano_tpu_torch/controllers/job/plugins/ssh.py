"""ssh plugin: RSA keypair in a Secret mounted into every pod for
passwordless MPI (reference: pkg/controllers/job/plugins/ssh/ssh.go:64-205).

The port's own copy of volcano_tpu/controllers/job/plugins/ssh.py.
"""

from __future__ import annotations

from typing import Dict, List

from ....models import objects as obj
from . import PluginInterface
from ...apis import make_pod_name

SSH_PRIVATE_KEY = "id_rsa"
SSH_PUBLIC_KEY = "id_rsa.pub"
SSH_AUTHORIZED_KEYS = "authorized_keys"
SSH_CONFIG = "config"
SSH_ABS_PATH = "/root/.ssh"


def generate_rsa_key() -> Dict[str, bytes]:
    """ssh.go:168-199 — 1024-bit RSA keypair + authorized_keys.

    Prefers the ``cryptography`` package; containers without it fall back
    to the dependency-free implementation (utils/rsa_fallback.py) — same
    serialized forms, so consumers can't tell which produced the Secret.
    """
    try:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
    except ImportError:
        from ....utils.rsa_fallback import generate_keypair
        return generate_keypair(1024)
    key = rsa.generate_private_key(public_exponent=65537, key_size=1024)
    private_pem = key.private_bytes(
        encoding=serialization.Encoding.PEM,
        format=serialization.PrivateFormat.TraditionalOpenSSL,
        encryption_algorithm=serialization.NoEncryption())
    public_ssh = key.public_key().public_bytes(
        encoding=serialization.Encoding.OpenSSH,
        format=serialization.PublicFormat.OpenSSH)
    return {SSH_PRIVATE_KEY: private_pem, SSH_PUBLIC_KEY: public_ssh,
            SSH_AUTHORIZED_KEYS: public_ssh}


def generate_ssh_config(job: obj.Job) -> str:
    """ssh.go:215-245 — StrictHostKeyChecking off + per-replica Host blocks."""
    lines = ["StrictHostKeyChecking no", "UserKnownHostsFile /dev/null"]
    for ts in job.spec.tasks:
        for i in range(ts.replicas):
            host = make_pod_name(job.metadata.name, ts.name, i)
            lines.append(f"Host {host}")
            lines.append(f"  HostName {host}.{job.metadata.name}")
    return "\n".join(lines)


class SshPlugin(PluginInterface):
    def __init__(self, store, arguments: List[str]):
        self.store = store
        self.arguments = arguments
        self.ssh_key_file_path = SSH_ABS_PATH
        for a in arguments:
            if a.startswith("--ssh-key-file-path="):
                self.ssh_key_file_path = a.split("=", 1)[1]

    def name(self) -> str:
        return "ssh"

    def _secret_name(self, job: obj.Job) -> str:
        return f"{job.metadata.name}-ssh"

    def on_pod_create(self, pod: obj.Pod, job: obj.Job) -> None:
        """Mount the keypair secret at the ssh path (ssh.go:119-166)."""
        mount = {"name": self._secret_name(job),
                 "mount_path": self.ssh_key_file_path,
                 "secret": self._secret_name(job)}
        for c in pod.spec.containers + pod.spec.init_containers:
            c.volume_mounts.append(dict(mount))

    def on_job_add(self, job: obj.Job) -> None:
        if job.status.controlled_resources.get("plugin-ssh") == "ssh":
            return
        ns = job.metadata.namespace
        if self.store.get("secrets", self._secret_name(job), ns) is None:
            data = generate_rsa_key()
            data[SSH_CONFIG] = generate_ssh_config(job).encode()
            self.store.create("secrets", obj.Secret(
                metadata=obj.ObjectMeta(
                    name=self._secret_name(job), namespace=ns,
                    owner=f"Job/{ns}/{job.metadata.name}"),
                data=data))
        job.status.controlled_resources["plugin-ssh"] = "ssh"

    def on_job_update(self, job: obj.Job) -> None:
        ns = job.metadata.namespace
        secret = self.store.get("secrets", self._secret_name(job), ns)
        if secret is None:
            self.on_job_add(job)
            return
        config = generate_ssh_config(job).encode()
        if secret.data.get(SSH_CONFIG) != config:
            secret.data[SSH_CONFIG] = config
            self.store.update("secrets", secret, skip_admission=True)

    def on_job_delete(self, job: obj.Job) -> None:
        if job.status.controlled_resources.get("plugin-ssh") != "ssh":
            return
        ns = job.metadata.namespace
        if self.store.get("secrets", self._secret_name(job), ns) is not None:
            self.store.delete("secrets", self._secret_name(job), ns, skip_admission=True)
        job.status.controlled_resources.pop("plugin-ssh", None)
