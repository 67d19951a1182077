"""Pod admission: /pods/validate + /pods/mutate
(reference: pkg/webhooks/admission/pods/{validate/admit_pod.go,
mutate/mutate_pod.go}).

Validation gates bare pods whose PodGroup is still Pending (so vanilla pods
respect gang admission) and checks disruption-budget annotations. Mutation
applies resource-group config: node selectors, tolerations and scheduler
name per group (the `--admission-conf` resourceGroups file).

The port's own copy of volcano_tpu/webhooks/pods.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..controllers.podgroup import generate_podgroup_name
from ..models import objects as obj
from ..models.objects import Pod, PodGroupPhase, Toleration
from .router import AdmissionDenied, AdmissionService, register_admission
from .util import validate_int_percentage_str

SCHEDULER_NAME = obj.DEFAULT_SCHEDULER_NAME


# -- validate (admit_pod.go:105-180) ----------------------------------------

def validate_pod(store, operation, pod: Pod, old=None) -> None:
    if pod.spec.scheduler_name != SCHEDULER_NAME:
        return
    pg_name = pod.metadata.annotations.get(obj.GROUP_NAME_ANNOTATION, "")
    if pg_name:
        _check_pg_phase(store, pod, pg_name, is_vc_job=True)
        return
    _check_pg_phase(store, pod, generate_podgroup_name(pod), is_vc_job=False)
    _validate_annotations(pod)


def _check_pg_phase(store, pod: Pod, pg_name: str, is_vc_job: bool) -> None:
    pg = store.get("podgroups", pg_name, pod.metadata.namespace)
    if pg is None:
        if is_vc_job:
            raise AdmissionDenied(
                f"failed to get PodGroup for pod "
                f"<{pod.metadata.key()}>: {pg_name} not found")
        return
    if pg.status.phase == PodGroupPhase.PENDING:
        raise AdmissionDenied(
            f"failed to create pod <{pod.metadata.key()}> as the podgroup "
            f"phase is Pending")


def _validate_annotations(pod: Pod) -> None:
    """admit_pod.go:156-181 — at most one JDB annotation, valid int/percent."""
    keys = (obj.JDB_MIN_AVAILABLE_KEY, obj.JDB_MAX_UNAVAILABLE_KEY)
    found = 0
    for key in keys:
        value = pod.metadata.annotations.get(key)
        if value is not None:
            found += 1
            err = validate_int_percentage_str(key, value)
            if err:
                raise AdmissionDenied(err)
    if found > 1:
        raise AdmissionDenied(
            f"not allow configure multiple annotations <{keys}> at same time")


# -- mutate (mutate_pod.go:100-170) -----------------------------------------

@dataclass
class ResGroupConfig:
    """One resourceGroup entry of the admission config
    (pkg/webhooks/config/admission_conf.go)."""
    resource_group: str = ""
    object_key: Dict[str, List[str]] = field(default_factory=dict)  # e.g. {"namespace": [...]} or {"annotation-key/value": [...]}
    labels: Dict[str, str] = field(default_factory=dict)            # node selector to apply
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = ""


_res_groups: List[ResGroupConfig] = []


def set_resource_groups(groups: List[ResGroupConfig]) -> None:
    """Install the admission config (the --admission-conf file equivalent)."""
    global _res_groups
    _res_groups = list(groups)


def _belongs(pod: Pod, group: ResGroupConfig) -> bool:
    """mutate_pod.go IsBelongResGroup: namespace or annotation match."""
    namespaces = group.object_key.get("namespace", [])
    if namespaces and pod.metadata.namespace in namespaces:
        return True
    ann = group.object_key.get("annotation", {})
    if isinstance(ann, dict):
        for k, v in ann.items():
            if pod.metadata.annotations.get(k) == v:
                return True
    return False


def mutate_pod(store, operation, pod: Pod, old=None) -> None:
    for group in _res_groups:
        if not _belongs(pod, group):
            continue
        if group.labels:
            pod.spec.node_selector.update(group.labels)
        if group.tolerations:
            pod.spec.tolerations.extend(group.tolerations)
        if group.scheduler_name:
            pod.spec.scheduler_name = group.scheduler_name
        return


register_admission(AdmissionService(
    path="/pods/validate", kind="pods", operations=("CREATE",),
    validate=validate_pod))
register_admission(AdmissionService(
    path="/pods/mutate", kind="pods", operations=("CREATE",),
    mutate=mutate_pod))
