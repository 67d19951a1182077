"""Admission control at the serving edge (the port's own copy of
volcano_tpu/serving/admission.py, docs/design/serving.md).

Every request at the HTTP seam carries a ``tenant=`` identity (absent =
``"default"``). Two enforcement points:

* **writes** — a per-tenant token bucket: ``admit_write`` either spends
  a token or raises :class:`ThrottledError` carrying the bucket's
  refill horizon, which the HTTP layer maps to a structured 429 with a
  ``Retry-After`` header (and RemoteStore honors in its write backoff).
* **subscriptions** — a per-tenant cap on concurrent hub subscriptions:
  ``acquire_subscription``/``release_subscription`` bracket a
  subscriber's lifetime; the cap rejects the storm of one noisy tenant
  without starving the others (each tenant's budget is its own).

Determinism: buckets read an injectable ``now_fn`` so the simulator can
drive them off the virtual clock — double runs then throttle the exact
same requests (the same property the resync backoff relies on).
Metrics: ``volcano_serving_admitted_total`` /
``volcano_serving_throttled_total`` per tenant, mirrored in
:meth:`AdmissionController.report` for /debug/serving.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..metrics import metrics as m
from ..metrics.metrics import SERVING_ADMITTED, SERVING_THROTTLED


class ThrottledError(Exception):
    """Raised when a tenant exceeds its admission budget. ``retry_after``
    is the seconds the caller should wait before retrying — the HTTP
    layer surfaces it as the 429 response's Retry-After header."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = max(0.0, float(retry_after))


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second, ``burst`` capacity.
    Not thread-safe on its own — the controller serializes access."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = now

    def take(self, cost: float, now: float):
        """(allowed, retry_after_seconds)."""
        if now > self.last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True, 0.0
        if self.rate <= 0:
            return False, 1.0
        return False, (cost - self.tokens) / self.rate


class TenantPolicy:
    """Per-tenant limits; the controller's defaults apply where a field
    is None."""

    __slots__ = ("write_rate", "write_burst", "max_subscriptions")

    def __init__(self, write_rate: Optional[float] = None,
                 write_burst: Optional[float] = None,
                 max_subscriptions: Optional[int] = None):
        self.write_rate = write_rate
        self.write_burst = write_burst
        self.max_subscriptions = max_subscriptions


class AdmissionController:
    """Per-tenant write rate limits + subscription caps.

    Defaults are deliberately generous (a single-tenant deployment never
    notices the edge exists); per-tenant overrides carry the real
    policy. ``now_fn`` defaults to ``time.monotonic``; the simulator
    passes the virtual clock's ``now`` for deterministic throttling.
    """

    DEFAULT_WRITE_RATE = 1000.0     # tokens (writes) per second
    DEFAULT_WRITE_BURST = 2000.0
    DEFAULT_MAX_SUBSCRIPTIONS = 1024

    def __init__(self, write_rate: float = None, write_burst: float = None,
                 max_subscriptions: int = None,
                 tenants: Dict[str, TenantPolicy] = None,
                 now_fn: Callable[[], float] = None):
        self.write_rate = float(write_rate
                                if write_rate is not None
                                else self.DEFAULT_WRITE_RATE)
        self.write_burst = float(write_burst
                                 if write_burst is not None
                                 else self.DEFAULT_WRITE_BURST)
        self.max_subscriptions = int(
            max_subscriptions if max_subscriptions is not None
            else self.DEFAULT_MAX_SUBSCRIPTIONS)
        self.tenants = dict(tenants or {})
        # lint: allow(clock-discipline): injectable now_fn — the sim passes the virtual clock; the production default is monotonic ON PURPOSE (token buckets must not rewind on wall jumps)
        self.now_fn = now_fn or time.monotonic
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._subs: Dict[str, int] = {}
        self.admitted: Dict[str, int] = {}
        self.throttled: Dict[str, int] = {}

    # -- policy resolution -------------------------------------------------

    def _policy(self, tenant: str) -> tuple:
        p = self.tenants.get(tenant)
        rate = p.write_rate if p and p.write_rate is not None \
            else self.write_rate
        burst = p.write_burst if p and p.write_burst is not None \
            else self.write_burst
        cap = p.max_subscriptions if p and p.max_subscriptions is not None \
            else self.max_subscriptions
        return rate, burst, cap

    def _count(self, table: Dict[str, int], tenant: str,
               metric_name: str) -> None:
        table[tenant] = table.get(tenant, 0) + 1
        m.inc(metric_name, tenant=tenant)

    # -- write edge --------------------------------------------------------

    def admit_write(self, tenant: str = "default", cost: float = 1.0) -> None:
        """Spend one write token or raise :class:`ThrottledError`."""
        now = self.now_fn()
        with self._lock:
            rate, burst, _ = self._policy(tenant)
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = TokenBucket(rate, burst, now)
            ok, retry_after = b.take(cost, now)
            if ok:
                self._count(self.admitted, tenant, SERVING_ADMITTED)
                return
            self._count(self.throttled, tenant, SERVING_THROTTLED)
        raise ThrottledError(
            f"tenant {tenant!r} exceeded its write rate "
            f"({rate:g}/s, burst {burst:g})", retry_after=retry_after)

    # -- watch edge --------------------------------------------------------

    def acquire_subscription(self, tenant: str = "default") -> None:
        """Claim one subscription slot or raise :class:`ThrottledError`.
        The caller MUST pair it with :meth:`release_subscription`."""
        with self._lock:
            _, _, cap = self._policy(tenant)
            held = self._subs.get(tenant, 0)
            if held >= cap:
                self._count(self.throttled, tenant, SERVING_THROTTLED)
                throttle = ThrottledError(
                    f"tenant {tenant!r} holds {held} subscriptions "
                    f"(cap {cap})", retry_after=5.0)
            else:
                self._subs[tenant] = held + 1
                self._count(self.admitted, tenant, SERVING_ADMITTED)
                return
        raise throttle

    def release_subscription(self, tenant: str = "default") -> None:
        with self._lock:
            held = self._subs.get(tenant, 0)
            if held <= 1:
                self._subs.pop(tenant, None)
            else:
                self._subs[tenant] = held - 1

    # -- observability -----------------------------------------------------

    def throttled_tenants(self) -> list:
        with self._lock:
            return sorted(t for t, n in self.throttled.items() if n > 0)

    def report(self) -> dict:
        with self._lock:
            return {
                "defaults": {"write_rate": self.write_rate,
                             "write_burst": self.write_burst,
                             "max_subscriptions": self.max_subscriptions},
                "subscriptions": dict(self._subs),
                "admitted": dict(self.admitted),
                "throttled": dict(self.throttled),
            }
