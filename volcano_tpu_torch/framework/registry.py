"""Plugin and action registries (counterpart of
volcano_tpu/framework/registry.py; reference: pkg/scheduler/framework/
plugins.go:37-119 + actions/factory.go).

Only this package's builtin plugins and actions register here; importing
the ``actions`` and ``plugins`` packages registers them. Out-of-tree plugin
loading is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

PluginBuilder = Callable  # (Arguments) -> Plugin

_plugin_builders: Dict[str, PluginBuilder] = {}
_actions: Dict[str, object] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    _ensure_builtins()
    return _plugin_builders.get(name)


def register_action(action) -> None:
    _actions[action.name()] = action


def get_action(name: str) -> Optional[object]:
    _ensure_builtins()
    return _actions.get(name)


def _ensure_builtins() -> None:
    from .. import actions as _actions_pkg   # noqa: F401 (registers via import)
    from .. import plugins as _plugins_pkg   # noqa: F401
