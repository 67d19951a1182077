"""Scheduling framework: conf, Session/Statement, registries, and the
placement solvers (DenseSolver over an encoded snapshot, BatchSolver over
a session's objects)."""

from .arguments import Arguments  # noqa: F401
from .conf import (PluginOption, SchedulerConfiguration, Tier,  # noqa: F401
                   default_scheduler_conf, parse_scheduler_conf)
from .framework import (close_session, job_status, open_session,  # noqa: F401
                        update_pod_group_condition)
from .plugin import Action, Plugin  # noqa: F401
from .registry import (get_action, get_plugin_builder,  # noqa: F401
                       register_action, register_plugin_builder)
from .session import (ABSTAIN, PERMIT, REJECT, Event, EventHandler,  # noqa: F401
                      Session, ValidateResult)
from .solver import (BatchSolver, DensePlacement, DenseSolver,  # noqa: F401
                     Placement, PlacementResult, PredicateFeatures,
                     QueueBudgets, fused_static_mask)
from .statement import Statement  # noqa: F401
