"""Tenant QoS policy plane: weighted fair share, rate limits,
admission control and the shed/park degradation ladder.

Counterpart of ``gelly_tpu/engine/qos.py``, of which it is a copy. The
engine's watermarks (``tenants.backlog_age_max_s``) and round
histograms (``tenants.round_ms``) are the *signals*; this module owns
the *policy* the reference delegates to Flink's runtime. It is pure host
bookkeeping — no device work, no locks shared with the engine — so the
scheduler can consult it inside its own critical sections without lock
ordering concerns (the controller's lock is a leaf).

Three decisions, one declarative :class:`QosPolicy` per tenant (or the
tier-wide default):

- **Weighted fair scheduling** (:meth:`QosController.plan_round`):
  deficit-round-robin over policy weights. Each scheduling round every
  backlogged tenant accrues ``weight / max_weight`` credit (so the
  heaviest tenant accrues exactly 1 and dispatches every round); a
  tenant dispatches when its credit reaches 1 and its token bucket
  (``rate_limit_cps`` chunks/sec, ``burst`` deep) has a token.
  Fairness bound: over any R consecutive rounds a continuously
  backlogged, un-limited tenant with weight w_i receives at least
  ``floor(R * w_i / w_max) - 1`` chunks — deficit carries over, so no
  tenant is starved below its weight share.
- **Admission control**: :meth:`MultiTenantEngine.admit` consults
  ``admission_ceiling_s`` against the worst ACTIVE tenant backlog age
  and either refuses (:class:`AdmissionRefused`) or queues the
  admission until pressure drains (``admission="queue"``).
- **The degradation ladder** (:meth:`QosController.evaluate`): a
  tenant over its ``backlog_budget_s`` for ``limit_after`` consecutive
  evaluations is **limited** (weight scaled by
  ``limited_weight_factor``, rate capped at ``degraded_rate_cps``);
  still over for ``park_after`` more, it is **parked** (the engine
  frees its lane via the idle-lane reclamation machinery, snapshots keep
  answering, the wire holds the stream); a parked tenant whose queue
  keeps growing past ``shed_queue_depth`` is **shed** (stream closed
  with a typed NACK). Parked tenants un-park automatically once the
  ACTIVE pressure drains below ``unpark_below_s`` — re-entering at
  the *limited* rung with a ``unpark_grace_s`` escalation holiday, so
  their own (necessarily stale) backlog cannot instantly re-park them.

Every transition is returned to the engine as an action string; the
engine publishes it on the bus (``qos.*`` counters/gauges — see the
``obs.bus`` glossary) and fires its ``on_qos`` hooks (the ingest
router maps park/unpark/shed onto wire PAUSE/RESUME/NACK).
"""

from __future__ import annotations

import dataclasses
import threading
import time

__all__ = [
    "AdmissionRefused",
    "QOS_LIMITED",
    "QOS_OK",
    "QOS_PARKED",
    "QOS_SHED",
    "QosController",
    "QosPolicy",
]

# Ladder states, mildest first. String-valued on purpose: they ride
# telemetry()/STATS/heartbeat payloads as-is.
QOS_OK = "ok"
QOS_LIMITED = "limited"
QOS_PARKED = "parked"
QOS_SHED = "shed"


class AdmissionRefused(RuntimeError):
    """``admit()`` refused a tenant: the engine is over its admission
    ceiling (``admission="refuse"``). Carries the pressure reading so
    callers can back off informedly."""

    def __init__(self, tenant_id, backlog_age_s: float, ceiling_s: float):
        super().__init__(
            f"tenant {tenant_id!r} refused admission: active backlog "
            f"age {backlog_age_s:.3f}s exceeds the admission ceiling "
            f"{ceiling_s:.3f}s — drain or shed before admitting more "
            "load (or construct the QosController with "
            "admission='queue')"
        )
        self.tenant_id = tenant_id
        self.backlog_age_s = backlog_age_s
        self.ceiling_s = ceiling_s


@dataclasses.dataclass(frozen=True)
class QosPolicy:
    """Declarative per-tenant (or tier-default) QoS contract.

    ``weight`` — fair-share weight (chunks per round relative to the
    heaviest tenant). ``rate_limit_cps`` — token-bucket rate in
    chunks/sec (None = unlimited), ``burst`` tokens deep.
    ``backlog_budget_s`` — the degradation trigger: ingress→durable
    backlog age above it counts an over-budget evaluation (None = the
    ladder never engages). ``limit_after`` / ``park_after`` —
    consecutive over-budget evaluations before the limit / park rungs.
    ``limited_weight_factor`` / ``degraded_rate_cps`` — the limited
    rung's effective weight multiplier and rate cap.
    ``unpark_below_s`` — un-park once ACTIVE pressure drains below
    this (default: half the budget); the same threshold clears the
    limited rung. ``unpark_grace_s`` — escalation holiday after an
    un-park. ``shed_queue_depth`` — a PARKED tenant whose queue grows
    past this is shed (None = never shed).
    """

    weight: float = 1.0
    rate_limit_cps: float | None = None
    backlog_budget_s: float | None = None
    limit_after: int = 1
    park_after: int = 3
    limited_weight_factor: float = 0.25
    degraded_rate_cps: float | None = None
    unpark_below_s: float | None = None
    unpark_grace_s: float = 0.5
    shed_queue_depth: int | None = None
    burst: float = 2.0

    def __post_init__(self):
        if not (self.weight > 0):
            raise ValueError(f"weight must be > 0, got {self.weight}")
        for name in ("rate_limit_cps", "degraded_rate_cps",
                     "backlog_budget_s", "unpark_below_s"):
            v = getattr(self, name)
            if v is not None and not (v > 0):
                raise ValueError(f"{name} must be > 0, got {v}")
        if self.limit_after < 1 or self.park_after < 1:
            raise ValueError(
                "limit_after and park_after must be >= 1 evaluations, "
                f"got {self.limit_after} / {self.park_after}"
            )
        if not (0 < self.limited_weight_factor <= 1):
            raise ValueError(
                "limited_weight_factor must be in (0, 1], got "
                f"{self.limited_weight_factor}"
            )
        if self.shed_queue_depth is not None and self.shed_queue_depth < 1:
            raise ValueError(
                f"shed_queue_depth must be >= 1, got "
                f"{self.shed_queue_depth}"
            )
        if not (self.burst >= 1):
            raise ValueError(f"burst must be >= 1 token, got {self.burst}")
        if self.unpark_grace_s < 0:
            raise ValueError(
                f"unpark_grace_s must be >= 0, got {self.unpark_grace_s}"
            )

    def unpark_threshold(self) -> float | None:
        """The drain level that un-parks / clears the limit: explicit
        ``unpark_below_s``, else half the backlog budget."""
        if self.unpark_below_s is not None:
            return self.unpark_below_s
        if self.backlog_budget_s is not None:
            return self.backlog_budget_s / 2.0
        return None


class _TenantQos:
    """Controller-private per-tenant scheduling state."""

    __slots__ = ("credit", "tokens", "t_tokens", "over_evals", "state",
                 "grace_until")

    def __init__(self, now: float, burst: float):
        self.credit = 0.0
        self.tokens = burst  # start with a full bucket
        self.t_tokens = now
        self.over_evals = 0
        self.state = QOS_OK
        self.grace_until = 0.0


class QosController:
    """The policy engine: per-tenant DRR credit, token buckets and
    ladder state. Thread-safe behind one leaf lock; the engine calls
    :meth:`plan_round` from its scheduling round and :meth:`evaluate`
    from its (rate-limited) QoS pass.

    ``default`` — the policy tenants fall back to; ``per_tenant`` —
    overrides keyed by tenant id (mutable later via
    :meth:`set_policy`). ``admission_ceiling_s`` + ``admission``
    ("refuse" | "queue") configure :meth:`MultiTenantEngine.admit`'s
    gate; ``eval_every_s`` paces the engine's ladder evaluations.
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, default: QosPolicy | None = None,
                 per_tenant: dict | None = None, *,
                 admission_ceiling_s: float | None = None,
                 admission: str = "refuse",
                 eval_every_s: float = 0.05,
                 clock=time.monotonic):
        if admission not in ("refuse", "queue"):
            raise ValueError(
                f"admission must be 'refuse' or 'queue', got {admission!r}"
            )
        if admission_ceiling_s is not None and not (admission_ceiling_s > 0):
            raise ValueError(
                f"admission_ceiling_s must be > 0, got "
                f"{admission_ceiling_s}"
            )
        self.default = default if default is not None else QosPolicy()
        self.admission_ceiling_s = admission_ceiling_s
        self.admission = admission
        self.eval_every_s = float(eval_every_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._policies: dict = dict(per_tenant or {})
        self._state: dict = {}

    # ------------------------------------------------------------ policies

    def policy_for(self, tenant_id) -> QosPolicy:
        with self._lock:
            return self._policies.get(tenant_id, self.default)

    def set_policy(self, tenant_id, policy: QosPolicy) -> None:
        """Install/replace one tenant's policy (takes effect on the
        next round/evaluation — no state reset: ladder position and
        accrued credit survive a policy tweak)."""
        if not isinstance(policy, QosPolicy):
            raise TypeError(f"expected QosPolicy, got {type(policy).__name__}")
        with self._lock:
            self._policies[tenant_id] = policy

    def state(self, tenant_id) -> str:
        """The tenant's ladder state (``ok`` for never-seen ids)."""
        with self._lock:
            st = self._state.get(tenant_id)
            return st.state if st is not None else QOS_OK

    def states(self) -> dict:
        """``{tenant_id: ladder state}`` for every tracked tenant."""
        with self._lock:
            return {tid: st.state for tid, st in self._state.items()}

    def counts(self) -> dict:
        """Ladder-state histogram — the ``qos.*_tenants`` gauges."""
        out = {QOS_OK: 0, QOS_LIMITED: 0, QOS_PARKED: 0, QOS_SHED: 0}
        with self._lock:
            for st in self._state.values():
                out[st.state] += 1
        return out

    def forget(self, tenant_id) -> None:
        """Drop a tenant's scheduling state (eviction cleanup)."""
        with self._lock:
            self._state.pop(tenant_id, None)

    def _st(self, tenant_id, pol: QosPolicy, now: float) -> _TenantQos:
        st = self._state.get(tenant_id)
        if st is None:
            st = self._state[tenant_id] = _TenantQos(now, pol.burst)
        return st

    # ----------------------------------------------------------- scheduling

    def plan_round(self, tenant_ids, now: float | None = None) -> set:
        """Deficit-round-robin grant set for one scheduling round.

        ``tenant_ids`` are the BACKLOGGED tenants (a chunk is queued);
        returns the subset granted a dispatch this round. Credit
        accrues at ``weight / max_weight`` per round (capped at one
        round's surplus, so an idle spell cannot bank unbounded burst)
        and a grant costs 1; the token bucket additionally gates
        limited/rate-capped tenants. Parked/shed tenants are never
        granted.
        """
        now = self._clock() if now is None else now
        granted: list = []
        with self._lock:
            entries: list = []
            wmax = 0.0
            for tid in tenant_ids:
                pol = self._policies.get(tid, self.default)
                st = self._st(tid, pol, now)
                if st.state in (QOS_PARKED, QOS_SHED):
                    continue
                w = pol.weight
                if st.state == QOS_LIMITED:
                    w *= pol.limited_weight_factor
                entries.append((tid, w, pol, st))
                wmax = max(wmax, w)
            if not entries:
                return set()
            for tid, w, pol, st in entries:
                quantum = w / wmax
                st.credit = min(st.credit + quantum, 1.0 + quantum)
                if st.credit < 1.0:
                    continue
                rate = pol.rate_limit_cps
                if st.state == QOS_LIMITED and pol.degraded_rate_cps is not None:
                    rate = (pol.degraded_rate_cps if rate is None
                            else min(rate, pol.degraded_rate_cps))
                if rate is not None:
                    st.tokens = min(
                        pol.burst,
                        st.tokens + (now - st.t_tokens) * rate,
                    )
                    st.t_tokens = now
                    if st.tokens < 1.0:
                        continue
                    st.tokens -= 1.0
                st.credit -= 1.0
                granted.append(tid)
        return set(granted)

    # ------------------------------------------------------------- ladder

    def evaluate(self, tenant_id, *, backlog_age_s: float,
                 queue_depth: int, active_backlog_max_s: float,
                 now: float | None = None) -> str | None:
        """Advance one tenant's ladder state; returns the transition
        ("limit" / "clear" / "park" / "unpark" / "shed") or None.

        ``backlog_age_s`` is the tenant's own ingress→durable age,
        ``queue_depth`` its engine queue, ``active_backlog_max_s`` the
        worst age across ACTIVE (un-parked) tenants — the un-park /
        admission pressure signal (a parked tenant's own ledger ages by
        construction and must not gate its own release)."""
        now = self._clock() if now is None else now
        with self._lock:
            pol = self._policies.get(tenant_id, self.default)
            st = self._st(tenant_id, pol, now)
            if st.state == QOS_SHED:
                return None
            if st.state == QOS_PARKED:
                if (pol.shed_queue_depth is not None
                        and queue_depth > pol.shed_queue_depth):
                    st.state = QOS_SHED
                    return "shed"
                thr = pol.unpark_threshold()
                if thr is not None and active_backlog_max_s < thr:
                    # Re-enter at the LIMITED rung with a grace
                    # holiday: the tenant's own backlog is stale from
                    # the park and must drain before full fair share.
                    st.state = QOS_LIMITED
                    st.over_evals = 0
                    st.grace_until = now + pol.unpark_grace_s
                    return "unpark"
                return None
            budget = pol.backlog_budget_s
            if budget is None:
                return None
            if backlog_age_s <= budget:
                st.over_evals = 0
                thr = pol.unpark_threshold()
                if (st.state == QOS_LIMITED
                        and backlog_age_s < (budget if thr is None else thr)):
                    st.state = QOS_OK
                    return "clear"
                return None
            if now < st.grace_until:
                return None  # un-park holiday: no escalation yet
            st.over_evals += 1
            if st.state == QOS_OK and st.over_evals >= pol.limit_after:
                st.state = QOS_LIMITED
                st.over_evals = 0
                return "limit"
            if st.state == QOS_LIMITED and st.over_evals >= pol.park_after:
                st.state = QOS_PARKED
                st.over_evals = 0
                return "park"
            return None
