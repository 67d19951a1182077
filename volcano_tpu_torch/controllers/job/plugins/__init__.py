"""Job controller plugins: hooks on pod create and job add/update/delete
(reference: pkg/controllers/job/plugins/interface/interface.go:39-50 and
plugins/factory.go registry).

Jobs request plugins via ``job.spec.plugins = {"svc": [...], "ssh": [...],
"env": [...]}``; the job controller invokes each named plugin's hooks.

The port's own copy of volcano_tpu/controllers/job/plugins/__init__.py.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ....models import objects as obj


class PluginInterface:
    """interface.go:39-50"""

    def name(self) -> str:
        raise NotImplementedError

    def on_pod_create(self, pod: obj.Pod, job: obj.Job) -> None:
        return None

    def on_job_add(self, job: obj.Job) -> None:
        return None

    def on_job_delete(self, job: obj.Job) -> None:
        return None

    def on_job_update(self, job: obj.Job) -> None:
        return None


PluginBuilder = Callable[[object, List[str]], PluginInterface]

_plugin_builders: Dict[str, PluginBuilder] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    return _plugin_builders.get(name)


def plugin_exists(name: str) -> bool:
    return name in _plugin_builders


def _register_builtins() -> None:
    from .env import EnvPlugin
    from .ssh import SshPlugin
    from .svc import SvcPlugin
    register_plugin_builder("env", lambda store, args: EnvPlugin(store, args))
    register_plugin_builder("ssh", lambda store, args: SshPlugin(store, args))
    register_plugin_builder("svc", lambda store, args: SvcPlugin(store, args))


_register_builtins()
