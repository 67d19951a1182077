"""Admission webhooks (reference: pkg/webhooks).

Importing this package registers every admission service (the reference's
init()-time router.RegisterAdmission); construct a :class:`WebhookManager`
over a store to enable them, optionally restricted via the
``enabled_admission`` path list (the --enabled-admission flag).

The port's own copy of volcano_tpu/webhooks/__init__.py.
"""

from . import jobs, podgroups, pods, queues  # noqa: F401  (register services)
from .pods import ResGroupConfig, set_resource_groups
from .router import (AdmissionDenied, AdmissionService, WebhookManager,
                     all_services, get_service, register_admission)

__all__ = [
    "AdmissionDenied", "AdmissionService", "WebhookManager", "all_services",
    "get_service", "register_admission", "ResGroupConfig",
    "set_resource_groups",
]
