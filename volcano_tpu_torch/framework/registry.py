"""Plugin and action registries (counterpart of
volcano_tpu/framework/registry.py; reference: pkg/scheduler/framework/
plugins.go:37-119 + actions/factory.go).

This package's builtin plugins and actions register here when the
``actions`` and ``plugins`` packages are imported. Out-of-tree plugins load
from a directory (``load_plugins_dir``, the scheduler's ``--plugins-dir``)
or through Python entry points in the ``volcano_tpu_torch.plugins`` group
(``load_custom_plugins``), the analogue of the reference's dynamic ``.so``
loading through plugin.Open/Lookup("New") (plugins.go:62-101). Their
builders return a subclass of this package's ``framework.plugin.Plugin``.
"""

from __future__ import annotations

import importlib.metadata
import importlib.util
import logging
import os
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

PluginBuilder = Callable  # (Arguments) -> Plugin

_plugin_builders: Dict[str, PluginBuilder] = {}
_actions: Dict[str, object] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    _ensure_builtins()
    if name not in _plugin_builders:
        load_custom_plugins()
    return _plugin_builders.get(name)


def register_action(action) -> None:
    _actions[action.name()] = action


def get_action(name: str) -> Optional[object]:
    _ensure_builtins()
    return _actions.get(name)


def load_plugins_dir(plugins_dir: str) -> List[str]:
    """Load every ``*.py`` file of ``plugins_dir`` (skipping names that
    start with ``_``) as a plugin module exposing ``New(arguments) ->
    Plugin`` and, optionally, ``Name() -> str`` (else the file's stem):
    the ``--plugins-dir`` flag, the reference's plugin.Open and
    Lookup("New") over ``.so`` files. A file that fails to load, or has
    no ``New``, is skipped. Returns the names registered."""
    loaded: List[str] = []
    if not plugins_dir or not os.path.isdir(plugins_dir):
        return loaded
    for fname in sorted(os.listdir(plugins_dir)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        path = os.path.join(plugins_dir, fname)
        try:
            spec = importlib.util.spec_from_file_location(
                f"volcano_tpu_torch_custom_{fname[:-3]}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            new = getattr(module, "New", None)
            if new is None:
                continue
            name = module.Name() if hasattr(module, "Name") else fname[:-3]
        except Exception:
            # a broken plugin file must not stop the scheduler: skip it,
            # as the reference does, and say which
            log.exception("skipping plugin file %s", path)
            continue
        register_plugin_builder(name, new)
        loaded.append(name)
    return loaded


def load_custom_plugins(group: str = "volcano_tpu_torch.plugins") -> None:
    """Register the plugin builders that installed packages publish as
    entry points of ``group``; a name already registered is kept."""
    for ep in importlib.metadata.entry_points(group=group):
        if ep.name not in _plugin_builders:
            try:
                _plugin_builders[ep.name] = ep.load()
            except Exception:
                log.exception("skipping plugin entry point %s", ep.name)


def _ensure_builtins() -> None:
    from .. import actions as _actions_pkg   # noqa: F401 (registers via import)
    from .. import plugins as _plugins_pkg   # noqa: F401
