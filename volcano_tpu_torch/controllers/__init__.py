"""Controller subsystem (reference: pkg/controllers).

Four controllers reconcile the control plane off store watches:
  * job-controller    — Job -> PodGroup + pods, lifecycle state machine
  * queue-controller  — Queue status rollups + open/closed state machine
  * pg-controller     — PodGroups for bare pods
  * gc-controller     — TTL-after-finished job deletion

``ControllerManager`` runs them together (the vc-controller-manager binary
equivalent); builders are registered like the reference's init() registry
(pkg/controllers/framework/framework.go).

The port's own copy of volcano_tpu/controllers/__init__.py.
"""

from .apis import JobInfo, Request, make_pod_name
from .cache import JobCache
from .framework import (Controller, ControllerManager, for_each_controller,
                        get_controller_builder, register_controller)
from .garbagecollector import GarbageCollector
from .job.controller import JobController
from .podgroup import PodGroupController
from .queue.controller import QueueController

register_controller("job-controller", JobController)
register_controller("queue-controller", QueueController)
register_controller("pg-controller", PodGroupController)
register_controller("gc-controller", GarbageCollector)

__all__ = [
    "Controller", "ControllerManager", "JobController", "QueueController",
    "PodGroupController", "GarbageCollector", "JobCache", "JobInfo", "Request",
    "make_pod_name", "register_controller", "get_controller_builder",
    "for_each_controller",
]
