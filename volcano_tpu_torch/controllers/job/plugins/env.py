"""env plugin: inject task index env vars into every container
(reference: pkg/controllers/job/plugins/env/env.go:45-83).

The port's own copy of volcano_tpu/controllers/job/plugins/env.py."""

from __future__ import annotations

from typing import List

from ....models import objects as obj
from . import PluginInterface
from ...apis import get_task_index

TASK_VK_INDEX = "VK_TASK_INDEX"
TASK_INDEX = "VC_TASK_INDEX"


class EnvPlugin(PluginInterface):
    def __init__(self, store, arguments: List[str]):
        self.store = store
        self.arguments = arguments

    def name(self) -> str:
        return "env"

    def on_pod_create(self, pod: obj.Pod, job: obj.Job) -> None:
        index = get_task_index(pod)
        for c in pod.spec.containers + pod.spec.init_containers:
            c.env[TASK_VK_INDEX] = index
            c.env[TASK_INDEX] = index

    def on_job_add(self, job: obj.Job) -> None:
        job.status.controlled_resources["plugin-env"] = "env"

    def on_job_delete(self, job: obj.Job) -> None:
        job.status.controlled_resources.pop("plugin-env", None)
