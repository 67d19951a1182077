"""Data model: resources, API objects, scheduler info wrappers, snapshot
arrays (the port's own copy of volcano_tpu/models)."""

from .resource import (EPS, INFINITY, ZERO, Resource, empty_resource,  # noqa: F401
                       min_resource)
from .objects import (Node, ObjectMeta, Pod, PodGroup,  # noqa: F401
                      PodGroupPhase, PriorityClass, Queue, QueueState)
from .job_info import (JobInfo, TaskInfo, TaskStatus, allocated_status,  # noqa: F401
                       get_job_id, get_task_id, get_task_status, is_terminated)
from .node_info import GPUDevice, NodeInfo  # noqa: F401
from .queue_info import NamespaceCollection, NamespaceInfo, QueueInfo  # noqa: F401
from .cluster_info import ClusterInfo  # noqa: F401
from .unschedule_info import FitError, FitErrors  # noqa: F401
from .arrays import bucket  # noqa: F401
