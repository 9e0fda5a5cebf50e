"""Admission control: per-tenant weighted-fair queuing, priorities, and
SLO-aware load shedding.

The port's copy of ``defer_tpu.serve.admission``: the same queue
discipline, decisions, registry names and event kinds.

The front door admits work in *units* (one unit = one sample, or one
decode request) into per-tenant FIFO queues and drains them through a
:class:`WeightedFairQueue`: strict priority between levels, start-time
fair queuing (SFQ — the classic virtual-clock WFQ approximation) within
a level, so a greedy tenant flooding its queue cannot starve a neighbor
beyond its weight share.

Shedding happens AT ADMISSION: the controller predicts this unit's
completion time from the current backlog and a live per-unit service
estimate (front-door-measured EWMA by default, or any object with a
``stage_effective_ms()`` method when wired) and rejects when the prediction
blows the request's deadline.  A rejected client gets a ``shed`` control
frame with a ``retry_after_ms`` hint instead of silently-late results —
bounded queues and honest p99s instead of collapse under overload.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable

from ..obs import REGISTRY
from ..obs.events import emit as emit_event


@dataclasses.dataclass
class TenantConfig:
    """Fairness/SLO knobs of one tenant."""

    name: str
    weight: float = 1.0         #: WFQ share within the priority level
    priority: int = 0           #: strict level; higher preempts lower
    deadline_ms: float | None = None  #: per-unit completion SLO
    max_queued: int = 4096      #: hard per-tenant backlog cap

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")
        if self.max_queued < 1:
            raise ValueError(f"tenant {self.name}: max_queued must be >= 1")


@dataclasses.dataclass
class ShedDecision:
    """Outcome of one admission attempt."""

    admitted: bool
    predicted_s: float = 0.0    #: predicted completion latency if admitted
    reason: str = ""            #: "deadline" | "backlog" | "" (admitted)
    retry_after_s: float = 0.0  #: hint: when the backlog should admit

    def to_json(self) -> dict:
        return {"admitted": self.admitted,
                "predicted_ms": round(self.predicted_s * 1e3, 3),
                "reason": self.reason,
                "retry_after_ms": round(self.retry_after_s * 1e3, 3)}


class _TenantQueue:
    __slots__ = ("cfg", "items", "finish_tag")

    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.items: collections.deque = collections.deque()
        #: SFQ finish tag of this tenant's last-enqueued unit
        self.finish_tag = 0.0


class WeightedFairQueue:
    """Strict-priority levels, start-time fair queuing within a level.

    Every unit costs 1 virtual unit over its tenant's weight; within a
    priority level the unit with the smallest start tag drains first,
    and the level's virtual clock follows the served tags — the textbook
    SFQ bound: over any backlogged interval two tenants' served counts
    differ from their weight ratio by at most one unit each.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._levels: dict[int, dict[str, _TenantQueue]] = {}
        self._vclock: dict[int, float] = {}
        self._size = 0

    def configure(self, cfg: TenantConfig) -> None:
        with self._lock:
            # a re-configure that changes priority MOVES the tenant's
            # queue (items included) to the new level — leaving it
            # registered in the old level would silently ignore the
            # repriority and double-count a later drop
            tq = None
            for prio, level in list(self._levels.items()):
                old = level.get(cfg.name)
                if old is not None:
                    tq = old
                    if prio != cfg.priority:
                        del level[cfg.name]
                        # the old level's virtual clock means nothing
                        # in the new level
                        tq.finish_tag = self._vclock.get(cfg.priority,
                                                         0.0)
                    break
            if tq is None:
                tq = _TenantQueue(cfg)
            tq.cfg = cfg
            self._levels.setdefault(cfg.priority, {})[cfg.name] = tq

    def qsize(self, tenant: str | None = None) -> int:
        with self._lock:
            if tenant is None:
                return self._size
            return sum(len(tq.items) for level in self._levels.values()
                       for name, tq in level.items() if name == tenant)

    def push(self, tenant: str, item: Any) -> None:
        """Enqueue one unit for ``tenant`` (configure() it first)."""
        with self._lock:
            for level in self._levels.values():
                tq = level.get(tenant)
                if tq is not None:
                    v = self._vclock.setdefault(tq.cfg.priority, 0.0)
                    start = max(v, tq.finish_tag)
                    tq.finish_tag = start + 1.0 / tq.cfg.weight
                    tq.items.append((start, item))
                    self._size += 1
                    self._ready.notify()
                    return
        raise KeyError(f"unknown tenant {tenant!r} (configure first)")

    def pop(self, timeout: float | None = 0.0) -> tuple[str, Any] | None:
        """Dequeue the next unit by priority-then-fair-share.

        ``timeout=0`` (default) never blocks; ``timeout=None`` blocks
        until a unit arrives; a positive timeout waits at most that
        long.  Returns ``None`` when nothing arrived."""
        with self._lock:
            if self._size == 0 and timeout != 0.0:
                self._ready.wait_for(lambda: self._size > 0,
                                     timeout=timeout)
            for prio in sorted(self._levels, reverse=True):
                level = self._levels[prio]
                best: _TenantQueue | None = None
                for tq in level.values():
                    if tq.items and (best is None
                                     or tq.items[0][0] < best.items[0][0]):
                        best = tq
                if best is not None:
                    start, item = best.items.popleft()
                    self._vclock[prio] = max(self._vclock.get(prio, 0.0),
                                             start)
                    self._size -= 1
                    return best.cfg.name, item
        return None

    def drop_tenant(self, tenant: str) -> int:
        """Discard every queued unit of ``tenant`` (client disconnect);
        returns the number dropped.  The tenant stays configured."""
        dropped = 0
        with self._lock:
            for level in self._levels.values():
                tq = level.get(tenant)
                if tq is not None:
                    n = len(tq.items)
                    tq.items.clear()
                    dropped += n
                    self._size -= n
        return dropped


class AdmissionController:
    """SLO-aware admission over a :class:`WeightedFairQueue`.

    ``service_s`` supplies the live per-unit service estimate (seconds a
    unit occupies the chain once scheduled, batch amortization already
    divided out).  The default estimator is the front door's measured
    EWMA (:meth:`observe_service`); wire :meth:`bind_cluster_view` to
    override it with a live bottleneck estimate (duck-typed: any object
    with ``stage_effective_ms()``), or seed it with ``seed_service_s``
    before any traffic has been measured.
    """

    def __init__(self, *, service_s: Callable[[], float] | None = None,
                 seed_service_s: float = 0.0, ewma: float = 0.25):
        self.queue = WeightedFairQueue()
        self._tenants: dict[str, TenantConfig] = {}
        self._lock = threading.Lock()
        self._service_s = service_s
        self._ewma_alpha = ewma
        self._ewma_s = max(0.0, seed_service_s)
        self._view = None
        self._view_width = 1
        #: units admitted but not yet completed (queued + in flight)
        self.inflight = 0
        self._qdelay = REGISTRY.histogram("serve.queue_delay_s")
        self._shed_total = REGISTRY.counter("serve.shed")
        self._admit_total = REGISTRY.counter("serve.admitted")

    # -- tenants -----------------------------------------------------------

    def configure(self, cfg: TenantConfig) -> None:
        with self._lock:
            self._tenants[cfg.name] = cfg
        self.queue.configure(cfg)
        # instantiate the per-tenant instruments up front so a tenant
        # that only ever gets shed still shows up in stats
        for c in ("admitted", "shed", "completed", "slo_measured",
                  "slo_ok"):
            REGISTRY.counter(f"serve.tenant.{cfg.name}.{c}")
        REGISTRY.histogram(f"serve.tenant.{cfg.name}.queue_delay_s")

    def tenant(self, name: str) -> TenantConfig:
        with self._lock:
            cfg = self._tenants.get(name)
        if cfg is None:
            raise KeyError(f"unknown tenant {name!r}")
        return cfg

    # -- live service estimate --------------------------------------------

    def observe_service(self, per_unit_s: float) -> None:
        """Fold one measured per-unit service time into the EWMA."""
        if per_unit_s <= 0:
            return
        with self._lock:
            a = self._ewma_alpha
            self._ewma_s = per_unit_s if self._ewma_s <= 0 \
                else (1 - a) * self._ewma_s + a * per_unit_s

    def bind_cluster_view(self, view, *, batch_width: int = 1) -> None:
        """Use ``view.stage_effective_ms()`` (the live bottleneck-stage
        estimate) as the service source: per-unit seconds = the slowest
        stage's per-frame ms over the batch width it serves."""
        with self._lock:
            self._view = view
            self._view_width = max(1, batch_width)

    def service_estimate_s(self) -> float:
        """Current per-unit service estimate, best source first."""
        if self._service_s is not None:
            return max(0.0, float(self._service_s()))
        with self._lock:
            view, width, ewma = self._view, self._view_width, self._ewma_s
        if view is not None:
            try:
                eff = view.stage_effective_ms()
            except Exception:  # noqa: BLE001 — live view died: fall back
                eff = None
            if eff:
                ms = max(eff.values())
                if ms > 0:
                    return ms / 1e3 / width
        return ewma

    # -- admission ---------------------------------------------------------

    def admit(self, tenant: str, item: Any, *,
              deadline_s: float | None = None,
              now: float | None = None) -> ShedDecision:
        """Admit one unit into ``tenant``'s queue, or shed it.

        Predicted completion = (units already admitted and not yet
        completed) x per-unit service + this unit's own service.  An
        explicit ``deadline_s`` overrides the tenant's configured
        ``deadline_ms``.  Sheds also fire on the per-tenant backlog cap
        regardless of SLO (an unbounded queue is never correct)."""
        del now  # reserved for tests that want a frozen clock
        cfg = self.tenant(tenant)
        if deadline_s is None and cfg.deadline_ms is not None:
            deadline_s = cfg.deadline_ms / 1e3
        unit_s = self.service_estimate_s()
        with self._lock:
            backlog = self.inflight
        predicted = (backlog + 1) * unit_s
        if self.queue.qsize(tenant) >= cfg.max_queued:
            dec = ShedDecision(False, predicted, "backlog",
                               retry_after_s=max(unit_s, 0.001))
        elif deadline_s is not None and unit_s > 0 \
                and predicted > deadline_s:
            # retry once enough backlog has drained that the SAME
            # prediction would fit the deadline
            excess = predicted - deadline_s
            dec = ShedDecision(False, predicted, "deadline",
                               retry_after_s=excess)
        else:
            dec = ShedDecision(True, predicted)
        t_cfg = cfg.name
        rid = getattr(item, "rid", None)
        if rid is None:
            rid = getattr(item, "request_id", None)
        if dec.admitted:
            with self._lock:
                self.inflight += 1
            self.queue.push(tenant, item)
            self._admit_total.n += 1
            REGISTRY.counter(f"serve.tenant.{t_cfg}.admitted").n += 1
            emit_event("admit", tenant=t_cfg, rid=rid,
                       backlog=backlog + 1)
        else:
            self._shed_total.n += 1
            REGISTRY.counter(f"serve.tenant.{t_cfg}.shed").n += 1
            emit_event("shed", tenant=t_cfg, rid=rid,
                       reason=dec.reason,
                       predicted_ms=round(dec.predicted_s * 1e3, 3),
                       retry_after_ms=round(dec.retry_after_s * 1e3, 3))
        return dec

    def complete(self, tenant: str, *, queued_at: float | None = None,
                 units: int = 1) -> None:
        """Mark ``units`` of ``tenant`` complete (result delivered or the
        unit was dropped with its client); records queue-delay when the
        admission timestamp is supplied."""
        with self._lock:
            self.inflight = max(0, self.inflight - units)
        REGISTRY.counter(f"serve.tenant.{tenant}.completed").n += units
        if queued_at is not None:
            dt = max(0.0, time.monotonic() - queued_at)
            self._qdelay.record(dt)
            REGISTRY.histogram(
                f"serve.tenant.{tenant}.queue_delay_s").record(dt)

    def record_slo(self, tenant: str, e2e_s: float) -> None:
        """Score one DELIVERED unit against its tenant's deadline —
        the per-tenant SLO-attainment fraction of the stats reply.  Units
        dropped with a dead client are never scored (they have no
        delivery latency), so attainment measures what tenants actually
        experienced."""
        try:
            cfg = self.tenant(tenant)
        except KeyError:
            return
        if cfg.deadline_ms is None:
            return
        REGISTRY.counter(f"serve.tenant.{tenant}.slo_measured").n += 1
        if e2e_s * 1e3 <= cfg.deadline_ms:
            REGISTRY.counter(f"serve.tenant.{tenant}.slo_ok").n += 1

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Per-tenant serving stats (the front door's ``stats`` reply)."""
        with self._lock:
            tenants = dict(self._tenants)
            inflight = self.inflight
        rows = {}
        for name, cfg in sorted(tenants.items()):
            measured = REGISTRY.counter(
                f"serve.tenant.{name}.slo_measured").value
            ok = REGISTRY.counter(f"serve.tenant.{name}.slo_ok").value
            rows[name] = {
                "weight": cfg.weight, "priority": cfg.priority,
                "deadline_ms": cfg.deadline_ms,
                "queued": self.queue.qsize(name),
                "admitted": REGISTRY.counter(
                    f"serve.tenant.{name}.admitted").value,
                "shed": REGISTRY.counter(
                    f"serve.tenant.{name}.shed").value,
                "completed": REGISTRY.counter(
                    f"serve.tenant.{name}.completed").value,
                "queue_delay_s": REGISTRY.histogram(
                    f"serve.tenant.{name}.queue_delay_s").summary(),
                # fraction of delivered units inside deadline_ms (None
                # until a deadline tenant has deliveries to score)
                "slo_attainment": (round(ok / measured, 4)
                                   if measured else None),
                "slo_measured": measured,
            }
        return {"tenants": rows, "inflight": inflight,
                "queued": self.queue.qsize(),
                "service_estimate_ms": round(
                    self.service_estimate_s() * 1e3, 4),
                "admitted": self._admit_total.value,
                "shed": self._shed_total.value,
                "queue_delay_s": self._qdelay.summary()}
