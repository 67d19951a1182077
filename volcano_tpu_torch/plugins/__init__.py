"""Builtin scheduler plugins of the port (reference: pkg/scheduler/plugins/
factory.go:37-56): the default conf's six, binpack, conformance and
task-topology.
Importing this package registers their builders."""

from . import binpack  # noqa: F401
from . import conformance  # noqa: F401
from . import drf  # noqa: F401
from . import gang  # noqa: F401
from . import nodeorder  # noqa: F401
from . import predicates  # noqa: F401
from . import priority  # noqa: F401
from . import proportion  # noqa: F401
from . import task_topology  # noqa: F401
