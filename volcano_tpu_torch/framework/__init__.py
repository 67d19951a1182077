"""The dense placement solve."""

from .solver import (DensePlacement, DenseSolver,  # noqa: F401
                     PredicateFeatures, QueueBudgets, fused_static_mask)
