"""Predicates, scoring, fair share and the gang-allocate loop in PyTorch.

Importing this package builds nothing: the CUDA kernel is compiled on the
first call of ops.cuda_allocate.gang_allocate_cuda with a CUDA tensor.
"""

from .fit import (group_fit_mask, pod_count_mask, resource_le,  # noqa: F401
                  selector_mask, static_predicate_mask, taint_mask)
from .score import (ScoreWeights, balanced_allocation_score,  # noqa: F401
                    binpack_score, least_requested_score,
                    most_requested_score, node_score)
from .fairshare import dominant_share, proportion_waterfill  # noqa: F401
from .allocate import AllocState, gang_allocate  # noqa: F401
