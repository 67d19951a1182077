"""The port's synth_arrays gives the same arrays, bit for bit and dtype for
dtype, as volcano_tpu.utils.synth.synth_arrays."""

import numpy as np
import pytest

from volcano_tpu.utils.synth import synth_arrays as ref_synth
from volcano_tpu_torch.utils.synth import synth_arrays


@pytest.mark.parametrize("n_tasks,n_nodes,kw", [
    (200, 60, dict(gang_size=4, seed=0)),
    (1000, 300, dict(gang_size=8, seed=42, utilization=0.3)),
    (250, 96, dict(gang_size=3, seed=7, n_queues=3)),
    (240, 50, dict(gang_size=6, seed=11, n_queues=2, n_namespaces=4,
                   utilization=0.7)),
    (90, 40, dict(gang_size=1, seed=3, n_namespaces=3, rack_affinity=False,
                  node_pad_to=512)),
])
def test_synth_arrays_identical(n_tasks, n_nodes, kw):
    ref = ref_synth(n_tasks, n_nodes, **kw)
    got = synth_arrays(n_tasks, n_nodes, **kw)
    assert len(got.args) == len(ref.args) == 28
    for name in got.as_dict():
        a, b = getattr(ref, name), getattr(got, name)
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert got.shapes == ref.shapes
