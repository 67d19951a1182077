"""drf plugin (the port's own copy of volcano_tpu/plugins/drf.py;
reference: pkg/scheduler/plugins/drf/drf.go).

Dominant Resource Fairness: per-job share = max_r allocated_r / total_r.
Extension points: Preemptable (preemptor share must stay below preemptee's,
with optional namespace-weighted policy), JobOrder (lowest share first),
NamespaceOrder, and — with ``enabledHierarchy`` — hierarchical DRF:
QueueOrder over the weighted share tree and Reclaimable via what-if tree
updates. Event handlers keep shares live as the session allocates/evicts.

The initial per-job share computation is one ``dominant_share`` call over
a dense [J,R] allocation matrix on the CPU (ops/fairshare.py) instead of
J×R host loops; incremental in-session updates are O(R) host math like the
reference's. The reference's share gauges are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..framework.plugin import Plugin
from ..framework.registry import register_plugin_builder
from ..framework.session import PERMIT, EventHandler
from ..models.arrays import ResourceIndex
from ..models.resource import Resource

NAME = "drf"
SHARE_DELTA = 0.000001


def _share_of(allocated: Resource, total: Resource) -> (str, float):
    """(dominant resource, share) with 0/0=0, x/0=1 (drf.go:621-646)."""
    res, dom = 0.0, ""
    for rn in total.resource_names():
        t = total.get(rn)
        a = allocated.get(rn)
        s = ((0.0 if a == 0 else 1.0) if t == 0 else a / t)
        if s > res:
            res, dom = s, rn
    return dom, res


class _DrfAttr:
    __slots__ = ("share", "dominant", "allocated", "version")

    def __init__(self, allocated: Optional[Resource] = None):
        self.share = 0.0
        self.dominant = ""
        self.allocated = allocated if allocated is not None else Resource()
        # bumped on every allocated mutation: preemptable_fn memoizes the
        # preemptor-side share against it (5k preemptors x ~3 node visits
        # re-derived the same clone+add+share chain otherwise)
        self.version = 0


class _HNode:
    """Hierarchical-DRF tree node (drf.go:42-76)."""

    __slots__ = ("parent", "attr", "request", "weight", "saturated",
                 "hierarchy", "children")

    def __init__(self, hierarchy: str, weight: float = 1.0,
                 attr: Optional[_DrfAttr] = None, leaf: bool = False):
        self.parent: Optional[_HNode] = None
        self.attr = attr if attr is not None else _DrfAttr()
        self.request = Resource()
        self.weight = weight
        self.saturated = False
        self.hierarchy = hierarchy
        self.children: Optional[Dict[str, _HNode]] = None if leaf else {}

    def clone(self, parent: Optional["_HNode"]) -> "_HNode":
        n = _HNode(self.hierarchy, self.weight,
                   leaf=self.children is None)
        n.parent = parent
        n.attr = _DrfAttr(self.attr.allocated.clone())
        n.attr.share = self.attr.share
        n.attr.dominant = self.attr.dominant
        n.request = self.request.clone()
        n.saturated = self.saturated
        if self.children is not None:
            n.children = {k: c.clone(n) for k, c in self.children.items()}
        return n


def _resource_saturated(allocated: Resource, request: Resource,
                        demanding: Dict[str, bool]) -> bool:
    """A leaf is saturated once any requested resource is fully allocated or
    a requested resource has no cluster headroom left (drf.go:78-93)."""
    for rn in allocated.resource_names():
        a, r = allocated.get(rn), request.get(rn)
        if a != 0 and r != 0 and a >= r:
            return True
        if not demanding.get(rn, False) and r != 0:
            return True
    return False


class DrfPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total = Resource()
        self.total_allocated = Resource()
        self.job_attrs: Dict[str, _DrfAttr] = {}
        self.namespace_opts: Dict[str, _DrfAttr] = {}
        self.root = _HNode("root", 1.0)

    def name(self) -> str:
        return NAME

    # -- session open ------------------------------------------------------

    def on_session_open(self, ssn) -> None:
        self.total = ssn.total_resource.clone()
        ns_enabled = ssn.plugin_enabled(NAME, "enabledNamespaceOrder") and \
            any(opt.name == NAME and "enabledNamespaceOrder" in opt.enabled
                for tier in ssn.tiers for opt in tier.plugins)
        hier_enabled = any(
            opt.name == NAME and opt.enabled.get("enabledHierarchy", False)
            for tier in ssn.tiers for opt in tier.plugins)

        # initial shares: one dense kernel call over [J, R]
        jobs = list(ssn.jobs.values())
        for job in jobs:
            # JobInfo.allocated is maintained as exactly the sum of
            # allocated-status task requests (add/delete/move paths), so
            # the per-task resum is one clone (drf.go:202-230 sums tasks
            # because Go's JobInfo lacks the running aggregate)
            attr = _DrfAttr(job.allocated.clone())
            self.job_attrs[job.uid] = attr
        self._batch_update_shares(jobs)
        for job in jobs:
            attr = self.job_attrs[job.uid]
            if ns_enabled:
                ns = self.namespace_opts.setdefault(job.namespace, _DrfAttr())
                ns.allocated.add(attr.allocated)
            if hier_enabled:
                queue = ssn.queues.get(job.queue)
                if queue is not None:
                    self.total_allocated.add(attr.allocated)
                    self._update_hierarchical_share(
                        self.root, self.total_allocated, job, attr,
                        queue.hierarchy, queue.hierarchical_weights)
        if ns_enabled:
            for ns, opt in self.namespace_opts.items():
                opt.dominant, opt.share = _share_of(opt.allocated, self.total)
            if ssn.solver is not None:
                def ns_budget(ns_name, rindex):
                    """Session-open namespace allocation + weight for the
                    kernel's live namespace re-selection (the in-scan form
                    of namespace_order_fn below; drf.go ns ordering)."""
                    opt = self.namespace_opts.get(ns_name)
                    info = ssn.namespace_info.get(ns_name)
                    weight = info.get_weight() if info else 1
                    alloc = rindex.vec(opt.allocated) if opt is not None \
                        else np.zeros(rindex.r, np.float32)
                    return alloc, float(weight)
                ssn.solver.set_namespace_budget_fn(ns_budget)

        _ls_memo: Dict[tuple, float] = {}

        def preemptable_fn(preemptor, preemptees):
            """Preemption allowed only while it narrows the share gap
            (drf.go:246-330)."""
            victims = []
            if ns_enabled:
                ns_info = ssn.namespace_info.get(preemptor.namespace)
                l_weight = ns_info.get_weight() if ns_info else 1
                l_ns = self.namespace_opts.get(preemptor.namespace, _DrfAttr())
                l_ns_alloc = l_ns.allocated.clone().add(preemptor.resreq)
                _, l_ns_share = _share_of(l_ns_alloc, self.total)
                l_ns_weighted = l_ns_share / l_weight

                ns_allocs: Dict[str, Resource] = {}
                undecided = []
                for preemptee in preemptees:
                    if preemptor.namespace == preemptee.namespace:
                        undecided.append(preemptee)
                        continue
                    alloc = ns_allocs.get(preemptee.namespace)
                    if alloc is None:
                        r_ns = self.namespace_opts.get(preemptee.namespace,
                                                       _DrfAttr())
                        alloc = r_ns.allocated.clone()
                        ns_allocs[preemptee.namespace] = alloc
                    r_info = ssn.namespace_info.get(preemptee.namespace)
                    r_weight = r_info.get_weight() if r_info else 1
                    alloc.sub(preemptee.resreq)
                    _, r_ns_share = _share_of(alloc, self.total)
                    r_ns_weighted = r_ns_share / r_weight
                    if l_ns_weighted < r_ns_weighted:
                        victims.append(preemptee)
                        continue
                    if l_ns_weighted - r_ns_weighted > SHARE_DELTA:
                        continue
                    undecided.append(preemptee)
                preemptees = undecided

            latt = self.job_attrs.get(preemptor.job, _DrfAttr())
            lkey = (preemptor.job, latt.version, id(preemptor.resreq))
            ls = _ls_memo.get(lkey)
            if ls is None:
                lalloc = latt.allocated.clone().add(preemptor.resreq)
                _, ls = _share_of(lalloc, self.total)
                _ls_memo[lkey] = ls

            allocations: Dict[str, Resource] = {}
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    ratt = self.job_attrs.get(preemptee.job, _DrfAttr())
                    allocations[preemptee.job] = ratt.allocated.clone()
                ralloc = allocations[preemptee.job].sub(preemptee.resreq)
                _, rs = _share_of(ralloc, self.total)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims, PERMIT

        ssn.add_preemptable_fn(NAME, preemptable_fn)

        if hier_enabled:
            def queue_order_fn(l, r) -> int:
                v = self._compare_queues(self.root, l, r)
                return 0 if v == 0 else (-1 if v < 0 else 1)

            ssn.add_queue_order_fn(NAME, queue_order_fn)

            def reclaimable_fn(reclaimer, reclaimees):
                """What-if tree evaluation per reclaimee (drf.go:347-404)."""
                victims = []
                total_allocated = self.total_allocated.clone()
                root = self.root.clone(None)

                ljob = ssn.jobs.get(reclaimer.job)
                if ljob is None or ljob.queue not in ssn.queues:
                    return [], PERMIT
                lqueue = ssn.queues[ljob.queue]
                lattr = _DrfAttr(
                    self.job_attrs[ljob.uid].allocated.clone())
                lattr.allocated.add(reclaimer.resreq)
                total_allocated.add(reclaimer.resreq)
                lattr.dominant, lattr.share = _share_of(lattr.allocated,
                                                        self.total)
                self._update_hierarchical_share(
                    root, total_allocated, ljob, lattr, lqueue.hierarchy,
                    lqueue.hierarchical_weights)

                for preemptee in reclaimees:
                    rjob = ssn.jobs.get(preemptee.job)
                    if rjob is None or rjob.queue not in ssn.queues:
                        continue
                    rqueue = ssn.queues[rjob.queue]
                    total_allocated.sub(preemptee.resreq)
                    rattr = _DrfAttr(
                        self.job_attrs[rjob.uid].allocated.clone())
                    rattr.allocated.sub(preemptee.resreq)
                    rattr.dominant, rattr.share = _share_of(rattr.allocated,
                                                            self.total)
                    self._update_hierarchical_share(
                        root, total_allocated, rjob, rattr, rqueue.hierarchy,
                        rqueue.hierarchical_weights)

                    ret = self._compare_queues(root, lqueue, rqueue)

                    total_allocated.add(preemptee.resreq)
                    rattr.allocated.add(preemptee.resreq)
                    rattr.dominant, rattr.share = _share_of(rattr.allocated,
                                                            self.total)
                    self._update_hierarchical_share(
                        root, total_allocated, rjob, rattr, rqueue.hierarchy,
                        rqueue.hierarchical_weights)

                    if ret < 0:
                        victims.append(preemptee)
                return victims, PERMIT

            ssn.add_reclaimable_fn(NAME, reclaimable_fn)

        def job_order_fn(l, r) -> int:
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            return 0 if ls == rs else (-1 if ls < rs else 1)

        ssn.add_job_order_fn(NAME, job_order_fn)

        if ns_enabled:
            def namespace_order_fn(l, r) -> int:
                lo = self.namespace_opts.get(l, _DrfAttr())
                ro = self.namespace_opts.get(r, _DrfAttr())
                li = ssn.namespace_info.get(l)
                ri = ssn.namespace_info.get(r)
                lw = li.get_weight() if li else 1
                rw = ri.get_weight() if ri else 1
                lws, rws = lo.share / lw, ro.share / rw
                return 0 if lws == rws else (-1 if lws < rws else 1)

            ssn.add_namespace_order_fn(NAME, namespace_order_fn)

        def _apply_total(job, total, sign):
            """The single share-update body (drf.go:466-511): per-task
            events pass one task's resreq, batched events a whole gang's
            sum — the arithmetic is identical because shares are recomputed
            from the running ``allocated`` aggregate either way."""
            if job is None:
                return
            attr = self.job_attrs.get(job.uid)
            if attr is None:
                return
            if sign > 0:
                attr.allocated.add(total)
            else:
                attr.allocated.sub(total)
            attr.version += 1
            attr.dominant, attr.share = _share_of(attr.allocated, self.total)
            if ns_enabled:
                ns = self.namespace_opts.setdefault(job.namespace, _DrfAttr())
                if sign > 0:
                    ns.allocated.add(total)
                else:
                    ns.allocated.sub(total)
                ns.dominant, ns.share = _share_of(ns.allocated, self.total)
            if hier_enabled and job.queue in ssn.queues:
                queue = ssn.queues[job.queue]
                if sign > 0:
                    self.total_allocated.add(total)
                else:
                    self.total_allocated.sub(total)
                self._update_hierarchical_share(
                    self.root, self.total_allocated, job, attr,
                    queue.hierarchy, queue.hierarchical_weights)

        ssn.add_event_handler(EventHandler(
            allocate_func=lambda e:
                _apply_total(ssn.jobs.get(e.task.job), e.task.resreq, +1),
            deallocate_func=lambda e:
                _apply_total(ssn.jobs.get(e.task.job), e.task.resreq, -1),
            batch_allocate_func=lambda job, tasks, total:
                _apply_total(job, total, +1),
            batch_deallocate_func=lambda job, tasks, total:
                _apply_total(job, total, -1)))

    # -- share math --------------------------------------------------------

    def _batch_update_shares(self, jobs) -> None:
        """All jobs' (dominant, share) in one call over [J, R]."""
        if not jobs:
            return
        from ..ops.fairshare import dominant_share

        rindex = ResourceIndex(set(self.total.scalars) | {
            rn for j in jobs
            for rn in self.job_attrs[j.uid].allocated.scalars})
        alloc = np.stack([rindex.vec(self.job_attrs[j.uid].allocated)
                          for j in jobs])
        total = rindex.vec(self.total)
        share, dom = dominant_share(torch.from_numpy(alloc),
                                    torch.from_numpy(total))
        share, dom = share.numpy(), dom.numpy()
        for i, j in enumerate(jobs):
            attr = self.job_attrs[j.uid]
            attr.share = float(share[i])
            attr.dominant = rindex.names[int(dom[i])] if share[i] > 0 else ""

    # -- hierarchical DRF --------------------------------------------------

    def _compare_queues(self, root: _HNode, lqueue, rqueue) -> float:
        """Walk the two hierarchy paths top-down (drf.go:170-200)."""
        lnode, rnode = root, root
        lpaths = lqueue.hierarchy.split("/")
        rpaths = rqueue.hierarchy.split("/")
        depth = min(len(lpaths), len(rpaths))
        for i in range(depth):
            if lnode is None or rnode is None:
                return 0.0
            if not lnode.saturated and rnode.saturated:
                return -1.0
            if lnode.saturated and not rnode.saturated:
                return 1.0
            lv = lnode.attr.share / lnode.weight
            rv = rnode.attr.share / rnode.weight
            if lv == rv:
                if i < depth - 1:
                    lnode = (lnode.children or {}).get(lpaths[i + 1])
                    rnode = (rnode.children or {}).get(rpaths[i + 1])
            else:
                return lv - rv
        return 0.0

    def _build_hierarchy(self, root: _HNode, job, attr: _DrfAttr,
                         hierarchy: str, weights: str) -> None:
        """Insert/refresh the job's leaf under its queue path
        (drf.go:529-568)."""
        inode = root
        paths = hierarchy.split("/")
        wparts = weights.split("/")
        for i in range(1, len(paths)):
            child = inode.children.get(paths[i])
            if child is None:
                try:
                    fweight = float(wparts[i])
                except (IndexError, ValueError):
                    fweight = 1.0
                fweight = max(fweight, 1.0)
                child = _HNode(paths[i], fweight)
                child.parent = inode
                inode.children[paths[i]] = child
            inode = child
        leaf = _HNode(job.uid, 1.0, attr, leaf=True)
        leaf.request = job.total_request.clone()
        leaf.parent = inode
        inode.children[job.uid] = leaf

    def _update_tree(self, node: _HNode, demanding: Dict[str, bool]) -> None:
        """Bottom-up share recomputation with min-dominant-share scaling
        (drf.go:572-617)."""
        if node.children is None:
            node.saturated = _resource_saturated(node.attr.allocated,
                                                 node.request, demanding)
            return
        mdr = 1.0
        for child in node.children.values():
            self._update_tree(child, demanding)
            if child.attr.share != 0 and not child.saturated:
                _, res_share = _share_of(child.attr.allocated, self.total)
                if res_share < mdr:
                    mdr = res_share
        node.attr.allocated = Resource()
        saturated = True
        for child in node.children.values():
            if not child.saturated:
                saturated = False
            if child.attr.share != 0:
                if child.saturated:
                    node.attr.allocated.add(child.attr.allocated)
                else:
                    node.attr.allocated.add(
                        child.attr.allocated.clone().multi(
                            mdr / child.attr.share))
        node.attr.dominant, node.attr.share = _share_of(node.attr.allocated,
                                                        self.total)
        node.saturated = saturated

    def _update_hierarchical_share(self, root: _HNode,
                                   total_allocated: Resource, job,
                                   attr: _DrfAttr, hierarchy: str,
                                   weights: str) -> None:
        if not hierarchy:
            hierarchy, weights = "root", "1"
        demanding: Dict[str, bool] = {}
        for rn in self.total.resource_names():
            if total_allocated.get(rn) < self.total.get(rn):
                demanding[rn] = True
        self._build_hierarchy(root, job, attr, hierarchy, weights)
        self._update_tree(root, demanding)

    def on_session_close(self, ssn) -> None:
        self.total = Resource()
        self.total_allocated = Resource()
        self.job_attrs = {}
        self.namespace_opts = {}
        self.root = _HNode("root", 1.0)


register_plugin_builder(NAME, DrfPlugin)
