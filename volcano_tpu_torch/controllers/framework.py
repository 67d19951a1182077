"""Controller framework: the Controller interface + registry
(reference: pkg/controllers/framework/{interface,framework}.go).

Controllers are event-driven components fed by store watches. Handlers only
enqueue work items; ``process_pending`` drains the queues (deterministic, used
directly in tests), and ``ControllerManager.run`` drives all registered
controllers on background threads for live operation (the controller-manager
binary equivalent, cmd/controller-manager/app/server.go).

The port's own copy of volcano_tpu/controllers/framework.py.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)


class Controller:
    """Base controller (interface.go:36-41): name + initialize + run."""

    NAME = "controller"

    def name(self) -> str:
        return self.NAME

    def initialize(self, store) -> None:
        raise NotImplementedError

    def process_pending(self, max_items: int = 10000) -> int:
        """Drain queued work; returns number of items processed."""
        raise NotImplementedError

    def stop(self) -> None:
        pass


_controller_registry: Dict[str, Callable[[], Controller]] = {}


def register_controller(name: str, builder: Callable[[], Controller]) -> None:
    """framework.go RegisterController equivalent."""
    _controller_registry[name] = builder


def for_each_controller(fn: Callable[[Callable[[], Controller]], None]) -> None:
    for builder in _controller_registry.values():
        fn(builder)


def get_controller_builder(name: str) -> Optional[Callable[[], Controller]]:
    return _controller_registry.get(name)


class ControllerManager:
    """Runs a set of controllers against one store (the vc-controller-manager
    process equivalent). ``sync()`` drains all controllers until quiescent --
    the deterministic test/simulation entry point; ``start()`` runs the same
    loop on a background thread."""

    def __init__(self, store, controllers: Optional[List[Controller]] = None):
        self.store = store
        if controllers is None:
            controllers = [b() for b in _controller_registry.values()]
        self.controllers = controllers
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for c in self.controllers:
            c.initialize(store)

    def sync(self, max_rounds: int = 100) -> int:
        """Drain every controller's queues until no controller has pending
        work (events produced by one controller may feed another)."""
        total = 0
        for _ in range(max_rounds):
            processed = 0
            for c in self.controllers:
                try:
                    processed += c.process_pending()
                except Exception:
                    # one controller's transient failure (e.g. a store update
                    # conflict racing another writer) must not stall the rest;
                    # its watch queue redelivers on the next round
                    log.exception("controller %s sync failed", c.name())
            total += processed
            if processed == 0:
                return total
        return total

    def start(self, interval: float = 0.05) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                try:
                    self.sync()
                except Exception:
                    log.exception("controller-manager sync loop failed")
                self._stop.wait(interval)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        for c in self.controllers:
            c.stop()
