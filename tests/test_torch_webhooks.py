"""The port's admission webhooks (volcano_tpu_torch/webhooks) held
against the JAX package's.

* The cases of tests/test_webhooks.py run on the port (``port_cases``).
* Each of those cases also runs on both packages under a recorder
  (tests/torch_job_parity.py:hold_case): every admission review's
  verdict, its message and the object as the mutating hooks left it,
  and what each store was left with, must be equal.
* The admission services both packages register: the same paths, kinds
  and operations, and ``--enabled-admission`` selects the same ones.

Tolerance: exact.
"""

import pytest

from tests import test_webhooks as ref_webhooks
from tests import torch_job_parity as tp
from tests.torch_reference_cases import port_cases

_webhooks = port_cases("test_webhooks")

TestJobMutate = _webhooks.TestJobMutate
TestJobValidate = _webhooks.TestJobValidate
TestQueueAdmission = _webhooks.TestQueueAdmission
TestPodAdmission = _webhooks.TestPodAdmission
TestPodGroupAdmission = _webhooks.TestPodGroupAdmission
TestEnabledAdmission = _webhooks.TestEnabledAdmission

CLASSES = ("TestJobMutate", "TestJobValidate", "TestQueueAdmission",
           "TestPodAdmission", "TestPodGroupAdmission",
           "TestEnabledAdmission")


def test_every_reference_case_is_ported():
    assert len(tp.case_names(ref_webhooks, CLASSES)) == 26


@pytest.mark.parametrize("case", tp.case_names(ref_webhooks, CLASSES))
def test_case_matches_reference(case):
    tp.hold_case(ref_webhooks, _webhooks, case)


def _services(pkg: str, enabled=None):
    router = tp.mod(pkg, "webhooks.router")
    tp.mod(pkg, "webhooks")     # registers the services
    return [(s.path, s.kind, tuple(s.operations), s.mutate is not None,
             s.validate is not None)
            for s in router.enabled_services(enabled)]


@pytest.mark.parametrize("enabled", [
    None, "/jobs/validate,/pods/mutate", "/queues/mutate, /podgroups/mutate",
    ""])
def test_registered_services_match_reference(enabled):
    got = _services(tp.PORT, enabled)
    assert got == _services(tp.REFERENCE, enabled)
    assert got if enabled != "" else not got
