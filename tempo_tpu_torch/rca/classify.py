"""Port of tempo_tpu/rca/classify.py, copied as is (host code).

Typed root-cause classification over an RCA evidence bundle.

Pure functions over plain dicts — the same code path classifies a live
incident (rca/engine.py) and an offline replay of a saved bundle
(`cli rca replay`), so an incident's attribution is reproducible from
its evidence alone.

Causes, in priority order (first signature that matches wins — the
ordering encodes "blame the strongest hard signal first"):

- ``handoff_dip``   — every vulture error in the window is the typed
                      blocklist-poll handoff transient (vulture.py);
                      SUPPRESSED: a known artifact, never a finding.
- ``backend_fault`` — the storage backend is provably unhealthy: an
                      open circuit breaker, quarantined blocks, or
                      vulture request/read failures against stored
                      tiers.
- ``overload_shed`` — the resource governor is at pressure/critical or
                      shed work during the window: the system chose to
                      degrade, nothing downstream is broken.
- ``upstream_service`` — temporal walks seeded at the burning service
                      concentrate on one dependency edge: the suspect
                      is another service, not this one.
- ``slow_stage``    — no hard fault, but one pipeline stage dominates
                      the affected queries' waterfalls.
- ``unknown``       — evidence insufficient; the incident still records
                      everything collected.
"""

from __future__ import annotations

CAUSES = ("handoff_dip", "backend_fault", "overload_shed",
          "upstream_service", "slow_stage", "unknown")

# vulture error types that indict the storage/read path (as opposed to
# the typed handoff artifact)
_BACKEND_ERROR_TYPES = ("request_failed", "notfound_byid", "notfound_search",
                        "missing_spans", "incorrect_result",
                        "metrics_mismatch")

# breaker gauge encoding (util/circuit.state_gauge): 0 closed,
# 1 half-open, 2 open
_BREAKER_OPEN = 2


def dominant_stage(evidence: dict) -> str | None:
    """The stage name that dominates the affected window: the summed
    insights stage waterfall first (it reflects the actual slow/failed
    queries), the `_self_` critical-path top entry as fallback."""
    stages = evidence.get("stageSeconds") or {}
    if stages:
        return max(sorted(stages), key=lambda s: stages[s])
    cp = evidence.get("criticalPath") or []
    if cp:
        top = cp[0]
        return top.get("key") or top.get("name")
    return None


def dominant_tier(evidence: dict) -> str | None:
    """The storage tier most represented among non-suppressed vulture
    errors in the window."""
    by_tier: dict[str, float] = {}
    for e in evidence.get("vultureErrors", []):
        if e.get("type") == "handoff_dip":
            continue
        tier = e.get("tier", "")
        if tier:
            by_tier[tier] = by_tier.get(tier, 0) + float(e.get("count", 0))
    if not by_tier:
        return None
    return max(sorted(by_tier), key=lambda t: by_tier[t])


def _backend_signals(evidence: dict) -> list[str]:
    sig = []
    for name, b in sorted((evidence.get("breakers") or {}).items()):
        if int(b.get("state", 0)) >= _BREAKER_OPEN:
            sig.append(f"circuit breaker {name!r} open")
    quarantine = evidence.get("quarantine") or {}
    n_quarantined = sum(len(v) for v in quarantine.values())
    if n_quarantined:
        sig.append(f"{n_quarantined} block(s) quarantined")
    backend_errs = sum(
        float(e.get("count", 0)) for e in evidence.get("vultureErrors", [])
        if e.get("type") in _BACKEND_ERROR_TYPES)
    if backend_errs:
        sig.append(f"{backend_errs:g} vulture backend-path error(s)")
    return sig


def classify(evidence: dict) -> dict:
    """Evidence bundle -> finding: {cause, suppressed, tier, service,
    stage, details}. Deterministic over the bundle (sorted tie-breaks
    everywhere), so live attribution and `cli rca replay` agree."""
    trigger = evidence.get("trigger") or {}
    service = trigger.get("service") or None
    stage = dominant_stage(evidence)
    tier = dominant_tier(evidence)
    suspects = evidence.get("suspects") or []

    verrs = evidence.get("vultureErrors", [])
    total_verrs = sum(float(e.get("count", 0)) for e in verrs)
    dip_only = (total_verrs > 0 and all(
        e.get("type") == "handoff_dip" for e in verrs if e.get("count")))

    def finding(cause: str, details: str, suppressed: bool = False) -> dict:
        top = suspects[0] if suspects else None
        return {
            "cause": cause,
            "suppressed": suppressed,
            "tier": tier,
            "service": service or (top["client"] if top else None),
            "stage": stage,
            "suspect": top,
            "details": details,
        }

    if dip_only:
        return finding(
            "handoff_dip",
            "every vulture error in the window is the typed blocklist-"
            "poll handoff transient — a known artifact, not an incident "
            "cause", suppressed=True)

    backend = _backend_signals(evidence)
    if backend:
        return finding("backend_fault", "; ".join(backend))

    gov = evidence.get("governor") or {}
    if int(gov.get("level", 0)) >= 1 or float(gov.get("shedDelta", 0)) > 0:
        return finding(
            "overload_shed",
            f"governor at {gov.get('levelName', 'pressure')}"
            + (f", shed {gov.get('shedDelta'):g} unit(s) of work"
               if gov.get("shedDelta") else ""))

    if suspects:
        top = suspects[0]
        # a dominant edge means the walks kept leaving the burning
        # service for the same dependency; a flat distribution does not
        # indict anyone
        second = suspects[1]["edgeVisits"] if len(suspects) > 1 else 0
        if top["edgeVisits"] >= max(2, 2 * second):
            return finding(
                "upstream_service",
                f"temporal walks concentrate on {top['edge']} "
                f"({top['edgeVisits']} visit(s))")

    if stage:
        return finding(
            "slow_stage",
            f"stage {stage!r} dominates the affected queries' waterfalls")

    return finding("unknown", "no signature matched the collected evidence")
