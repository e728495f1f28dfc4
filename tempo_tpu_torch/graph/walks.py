"""Temporal random walks over the aggregated service graph.

Per "A GPU Accelerated Temporal Window-Based Random Walk Sampler"
(PAPERS.md): walks explore the dependency graph for hotspot/root-cause
surfacing, and transitions are TIME-CONSTRAINED — an edge can only be
taken if it was observed no earlier than the walk's current time (and,
with a window, not further ahead than window_s), so a walk follows
plausible causal chains instead of teleporting across the retention
period. Edge timestamps come from the aggregation's min/max server-span
start seconds.

Determinism is the contract: every random decision is
splitmix64(seed, walk, step, salt) — the same construction
backend/faults.py replays fault schedules with (hash() is
PYTHONHASHSEED-salted and would flake cross-process replay), and all
iteration orders are sorted, so the same seed over the same edge wire
replays bit-identically across processes.

Port of tempo_tpu/graph/walks.py (sample_walks, rank_suspects and
tempo_tpu_graph_walk_steps_total), host code.
"""

from __future__ import annotations

from tempo_tpu_torch.util import metrics

_MASK = (1 << 64) - 1

walk_steps_total = metrics.counter(
    "tempo_tpu_graph_walk_steps_total",
    "Random-walk transitions sampled over the service graph",
)


def _mix(*parts: int) -> int:
    """splitmix64-style hash of integer parts (backend/faults._mix
    construction; duplicated here so the graph plane never imports the
    fault-injection module)."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (p & _MASK)) * 0xBF58476D1CE4E5B9 & _MASK
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK
    x ^= x >> 31
    return x


def _u01(seed: int, walk: int, step: int, salt: int) -> float:
    return (_mix(seed, walk, step, salt) >> 11) / float(1 << 53)


def _pick(weighted: list, r: float):
    """Weighted choice: weights are integer counts, r in [0,1)."""
    total = sum(w for _, w in weighted)
    target = r * total
    run = 0
    for item, w in weighted:
        run += w
        if target < run:
            return item
    return weighted[-1][0]


def sample_walks(edges: dict, seed: int = 0, walks: int = 32, steps: int = 6,
                 window_s: int = 0, start: str | None = None) -> dict:
    """Sample `walks` temporal random walks over a merged deps wire's
    edge map ({client<EDGE_SEP>server: {count, minStartS, maxStartS}}).

    Transition rule from node u at walk-time t: candidate edges are u's
    outgoing edges with maxStartS >= t (observed not-before the walk's
    present) and, when window_s > 0, minStartS <= t + window_s; one is
    chosen with probability proportional to its traversal count, and t
    advances to max(t, edge.minStartS). Walks stop at dead ends.

    Returns {"walks": [...], "visits": {node: n}, "edgeVisits": {...}}.
    """
    from tempo_tpu_torch.graph import EDGE_SEP

    adj: dict[str, list] = {}
    for key in sorted(edges):
        client, server = key.split(EDGE_SEP, 1)
        e = edges[key]
        adj.setdefault(client, []).append(
            (server, int(e["count"]), int(e["minStartS"]), int(e["maxStartS"]))
        )
    # start distribution: the requested node, else every node with
    # outgoing edges weighted by its total outgoing traffic
    if start is not None:
        if start not in adj:
            # the graph plane's client-error contract (-> 400): a typo'd
            # or edge-less start node must not read as "graph is empty"
            raise ValueError(
                f"walk start node {start!r} has no outgoing edges in the "
                "selected graph (check the service name / root filter)"
            )
        starts = [(start, 1)]
    else:
        starts = [(u, sum(w for _, w, _, _ in out)) for u, out in sorted(adj.items())]

    visits: dict[str, int] = {}
    edge_visits: dict[str, int] = {}
    out_walks = []
    n_steps = 0  # counter bumped ONCE per request, not per transition
    for w in range(max(0, walks)):
        if not starts:
            break
        u = _pick(starts, _u01(seed, w, 0, 0))
        t = None  # walk time latches on the first transition
        path = [u]
        visits[u] = visits.get(u, 0) + 1
        for step in range(1, max(1, steps) + 1):
            cands = []
            for item in adj.get(u, ()):
                _, cnt, mn, mx = item
                if t is not None and mx < t:
                    continue  # edge predates the walk's present
                if window_s > 0 and t is not None and mn > t + window_s:
                    continue  # edge beyond the temporal window
                cands.append((item, cnt))
            if not cands:
                break
            v, cnt, mn, mx = _pick(cands, _u01(seed, w, step, 1))
            t = mn if t is None else max(t, mn)
            path.append(v)
            visits[v] = visits.get(v, 0) + 1
            ek = f"{path[-2]} -> {v}"
            edge_visits[ek] = edge_visits.get(ek, 0) + 1
            n_steps += 1
            u = v
        out_walks.append({"path": path, "steps": len(path) - 1})
    if n_steps:
        walk_steps_total.inc(n_steps)
    return {
        "walks": out_walks,
        "visits": dict(sorted(visits.items(), key=lambda kv: (-kv[1], kv[0]))),
        "edgeVisits": dict(sorted(edge_visits.items(), key=lambda kv: (-kv[1], kv[0]))),
        "seed": seed,
    }


def rank_suspects(walk_doc: dict, exclude: tuple = (), top: int = 5) -> list[dict]:
    """Rank suspect dependency edges out of a sample_walks document.

    Walks seeded at a burning service follow the call direction, so the
    edges they traverse most are the dependencies most causally coupled
    to the burning node inside the temporal window — the RCA plane's
    "upstream suspect" ranking. Deterministic: ties break by edge name,
    and the input doc is itself seed-deterministic, so the same incident
    replays to the same ranking (`cli rca replay`)."""
    visits = walk_doc.get("visits", {})
    suspects = []
    for ek, n in walk_doc.get("edgeVisits", {}).items():
        client, _, server = ek.partition(" -> ")
        if server in exclude:
            continue
        suspects.append({
            "edge": ek,
            "client": client,
            "server": server,
            "edgeVisits": int(n),
            "serverVisits": int(visits.get(server, 0)),
        })
    suspects.sort(key=lambda s: (-s["edgeVisits"], -s["serverVisits"],
                                 s["edge"]))
    return suspects[: max(1, top)]
