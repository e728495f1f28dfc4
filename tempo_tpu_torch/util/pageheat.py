"""PageHeat ledger + ghost-LRU what-if residency simulator.

Port of tempo_tpu/util/pageheat.py, copied as is (host code): the
ledger the block readers feed on every query-path page access, the
ghost-LRU what-if curve, the admission API the device tier
(encoding/vtpu/colcache.DeviceTier) reads, /status/device's document and
the periodic exporter.

The transfer plane (util/devicetiming) says HOW MANY bytes cross the
host<->device boundary; this ledger says WHICH (block, column) pages
cross it again and again — the admission/eviction signal the
device-resident hot tier consumes: measure first, relocate second
(RESYSTANCE, PAPERS.md).

Three parts:

1. **Ledger** — every query-path page access (EncodedColumn run/dict
   reads, VtpuBackendBlock.read_columns through the shared column
   cache) records a touch: re-ship count, bytes moved vs the page's
   encoded (stored) size — the TRANSFER AMPLIFICATION — and recency.
   Memory is bounded the same way the usage accountant bounds tenants:
   idle pages past a TTL are evicted, a hard entry cap drops the
   coldest, and the access stream is a fixed-length ring.
2. **Ghost-LRU what-if curve** — a stack-distance simulation over the
   access stream at 4-8 candidate HBM budgets: "pinning the top N MB of
   compressed pages in device memory would have eliminated X% of
   transfer bytes". LRU is a stack algorithm, so the miss-ratio curve
   is monotone non-increasing in budget by construction (per-access
   reuse distance compared against every budget at once).
3. **Export** — /status/device serves the hot-set report + curve live;
   a StorageScanner-style periodic exporter refreshes the
   tempo_tpu_pageheat_* gauges (including the per-budget miss-ratio
   gauges dashboards graph) and, when TEMPO_TPU_PAGEHEAT_EXPORT_DIR is
   set, writes a JSON snapshot `cli analyse device` replays offline.

Budgets are expressed as fixed fractions of the observed unique working
set (1/16 .. 1x) so the gauge labels stay a bounded enum while the byte
values track the fleet; explicit byte budgets can be passed anywhere a
report is computed.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

from tempo_tpu_torch.util import metrics

log = logging.getLogger(__name__)

ships_total = metrics.counter(
    "tempo_tpu_pageheat_ships_total",
    "Query-path page accesses recorded by the page-heat ledger (each is "
    "one host->device ship the hot tier could have elided)",
)
ship_bytes_total = metrics.counter(
    "tempo_tpu_pageheat_ship_bytes_total",
    "Bytes moved by ledger-recorded page accesses (decoded/run-space "
    "size shipped per access, summed)",
)
evictions_total = metrics.counter(
    "tempo_tpu_pageheat_evictions_total",
    "Ledger entries dropped by the idle-TTL / entry-cap eviction",
)
tracked_pages_gauge = metrics.gauge(
    "tempo_tpu_pageheat_tracked_pages",
    "Distinct (block, column, page) entries currently in the ledger",
)
stream_entries_gauge = metrics.gauge(
    "tempo_tpu_pageheat_stream_entries",
    "Access-stream ring occupancy feeding the ghost-LRU simulation",
)
miss_ratio_gauge = metrics.gauge(
    "tempo_tpu_pageheat_miss_ratio",
    "Ghost-LRU what-if miss ratio (fraction of moved bytes NOT "
    "eliminated) per candidate HBM budget, labelled by working-set "
    "fraction",
)
budget_bytes_gauge = metrics.gauge(
    "tempo_tpu_pageheat_budget_bytes",
    "Byte value of each candidate HBM budget the miss-ratio gauge was "
    "computed at",
)

# candidate HBM budgets as fractions of the unique working set: bounded
# label enum for the gauges, tracks fleet size automatically
BUDGET_FRACTIONS = (
    ("1/16", 1 / 16), ("1/8", 1 / 8), ("1/4", 1 / 4),
    ("1/2", 1 / 2), ("3/4", 3 / 4), ("1", 1.0),
)


class PageHeatLedger:
    """Thread-safe per-(block, column, page) re-ship accounting with a
    bounded access-stream ring. Touch is on the query hot path: one
    lock, dict upsert, deque append."""

    MAX_PAGES = 8192
    PAGE_IDLE_TTL_S = 600.0
    STREAM_CAP = 65536
    _EVICT_PERIOD_S = 60.0

    def __init__(self, max_pages: int | None = None,
                 stream_cap: int | None = None):
        self.max_pages = max_pages or self.MAX_PAGES
        self.stream_cap = stream_cap or self.STREAM_CAP
        self._lock = threading.Lock()
        # key -> [ships, moved_bytes, encoded_bytes, first_mono, last_mono]
        self._entries: dict[tuple, list] = {}
        self._key_ids: dict[tuple, int] = {}
        self._id_keys: dict[int, tuple] = {}
        self._next_id = 0
        # ring of (seq, key_id, encoded_bytes, moved_bytes)
        self._stream: deque = deque(maxlen=self.stream_cap)
        self._seq = 0
        self._last_evict = time.monotonic()
        # lifetime totals: entry eviction never decrements these, so
        # they stay bit-equal to the pageheat counters (the loadtest's
        # ledger==counters gate)
        self.lifetime_ships = 0
        self.lifetime_moved_bytes = 0

    # ------------------------------------------------------------------
    def touch(self, block_id, column: str, offset: int,
              moved_bytes: int, encoded_bytes: int) -> None:
        """Record one query-path access: `moved_bytes` is what ships to
        the device for this access (decoded or run-space size);
        `encoded_bytes` is the page's stored size — the HBM cost of
        pinning it compressed."""
        if moved_bytes <= 0:
            return
        key = (str(block_id), column, int(offset))
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = [1, moved_bytes, encoded_bytes, now, now]
            else:
                e[0] += 1
                e[1] += moved_bytes
                e[2] = encoded_bytes
                e[4] = now
            kid = self._key_ids.get(key)
            if kid is None:
                kid = self._key_ids[key] = self._next_id
                self._id_keys[kid] = key
                self._next_id += 1
            self._seq += 1
            self._stream.append((self._seq, kid, int(encoded_bytes),
                                 int(moved_bytes)))
            self.lifetime_ships += 1
            self.lifetime_moved_bytes += int(moved_bytes)
        # counters OUTSIDE the ledger lock; the loadtest gate checks
        # ledger totals == these counters at quiesce
        ships_total.inc()
        ship_bytes_total.inc(moved_bytes)
        if now - self._last_evict > self._EVICT_PERIOD_S:
            self._last_evict = now
            self.evict_idle()

    # ------------------------------------------------------------------
    def evict_idle(self, older_than_s: float | None = None) -> int:
        """Drop idle entries (TTL) and, beyond the cap, the coldest by
        recency — the usage-accountant discipline so churned blocklists
        can't grow the ledger forever. Interned key ids referenced by
        neither an entry nor the stream are garbage-collected too."""
        ttl = self.PAGE_IDLE_TTL_S if older_than_s is None else older_than_s
        now = time.monotonic()
        with self._lock:
            victims = [k for k, e in self._entries.items() if now - e[4] > ttl]
            for k in victims:
                del self._entries[k]
            if len(self._entries) > self.max_pages:
                by_age = sorted(self._entries.items(), key=lambda kv: kv[1][4])
                for k, _ in by_age[: len(self._entries) - self.max_pages]:
                    del self._entries[k]
                    victims.append(k)
            if victims:
                live = {self._key_ids[k] for k in self._entries
                        if k in self._key_ids}
                live |= {kid for _, kid, _, _ in self._stream}
                for kid in [i for i in self._id_keys if i not in live]:
                    del self._key_ids[self._id_keys.pop(kid)]
        if victims:
            evictions_total.inc(len(victims))
        return len(victims)

    # ------------------------------------------------------------------
    def mark(self) -> int:
        """Current stream sequence — pair with window_report() to
        correlate an external capture (the device profiler) with exactly
        the accesses that happened during it."""
        with self._lock:
            return self._seq

    def window_report(self, since_seq: int, top: int = 20) -> dict:
        """Accesses after `since_seq`: the transfer-ledger view of one
        bounded window (the /status/profile/device correlation)."""
        with self._lock:
            window = [(kid, enc, mv) for seq, kid, enc, mv in self._stream
                      if seq > since_seq]
            keys = dict(self._id_keys)
        per_page: dict[int, list] = {}
        moved = 0
        for kid, enc, mv in window:
            moved += mv
            row = per_page.setdefault(kid, [0, 0, enc])
            row[0] += 1
            row[1] += mv
        pages = sorted(per_page.items(), key=lambda kv: -kv[1][1])[:top]
        return {
            "sinceSeq": since_seq,
            "accesses": len(window),
            "movedBytes": moved,
            "pages": [
                {
                    "block": keys[kid][0], "column": keys[kid][1],
                    "offset": keys[kid][2], "ships": n,
                    "movedBytes": mv, "encodedBytes": enc,
                }
                for kid, (n, mv, enc) in pages if kid in keys
            ],
        }

    # ------------------------------------------------------------------
    def snapshot(self, top: int = 50) -> dict:
        """Ledger rollup: totals, amplification, hot set, pinning table."""
        now = time.monotonic()
        with self._lock:
            entries = {k: list(e) for k, e in self._entries.items()}
            stream_len = len(self._stream)
            lifetime_ships = self.lifetime_ships
            lifetime_moved = self.lifetime_moved_bytes
        total_ships = sum(e[0] for e in entries.values())
        total_moved = sum(e[1] for e in entries.values())
        unique_enc = sum(e[2] for e in entries.values())
        rows = sorted(entries.items(), key=lambda kv: -kv[1][1])
        hot = [
            {
                "block": k[0], "column": k[1], "offset": k[2],
                "ships": e[0], "movedBytes": e[1], "encodedBytes": e[2],
                "amplification": round(e[1] / max(e[2], 1), 3),
                "idleS": round(now - e[4], 1),
            }
            for k, e in rows[:top]
        ]
        # pinning table: if the top pages (by moved bytes) were resident
        # compressed in HBM, every re-ship after the first disappears
        pinning = []
        cum_enc = cum_saved = 0
        for i, (_k, e) in enumerate(rows):
            cum_enc += e[2]
            cum_saved += max(0, e[1] - e[2])
            if i + 1 in (1, 2, 4, 8, 16, 32, 64, 128, 256) or i + 1 == len(rows):
                pinning.append({
                    "pages": i + 1,
                    "pinnedBytes": cum_enc,
                    "savedBytes": cum_saved,
                    "savedRatio": round(cum_saved / max(total_moved, 1), 4),
                })
        return {
            "trackedPages": len(entries),
            "streamEntries": stream_len,
            "totalShips": total_ships,
            "totalMovedBytes": total_moved,
            # monotonic, eviction-immune: bit-equal to the
            # tempo_tpu_pageheat_* counters by construction
            "lifetimeShips": lifetime_ships,
            "lifetimeMovedBytes": lifetime_moved,
            "uniqueEncodedBytes": unique_enc,
            "amplification": round(total_moved / max(unique_enc, 1), 3),
            "hotSet": hot,
            "pinning": pinning,
        }

    def access_stream(self) -> list:
        """[(key_id, encoded_bytes, moved_bytes)] oldest-first — the
        ghost-LRU input."""
        with self._lock:
            return [(kid, enc, mv) for _seq, kid, enc, mv in self._stream]

    def key_table(self) -> dict:
        with self._lock:
            return dict(self._id_keys)

    def reset(self) -> None:
        """Test hook (counters keep their monotonic values)."""
        with self._lock:
            self._entries.clear()
            self._key_ids.clear()
            self._id_keys.clear()
            self._stream.clear()
            self._next_id = 0
            self._seq = 0
            self.lifetime_ships = 0
            self.lifetime_moved_bytes = 0


LEDGER = PageHeatLedger()


def touch(block_id, column: str, offset: int, moved_bytes: int,
          encoded_bytes: int) -> None:
    LEDGER.touch(block_id, column, offset, moved_bytes, encoded_bytes)


def _refresh_size_gauges() -> None:
    with LEDGER._lock:
        tracked_pages_gauge.set(len(LEDGER._entries))
        stream_entries_gauge.set(len(LEDGER._stream))


metrics.register_collector(_refresh_size_gauges)


# ---------------------------------------------------------------------------
# ghost-LRU what-if simulation
# ---------------------------------------------------------------------------


class _Fenwick:
    """Prefix-sum tree over stream positions, holding each key's encoded
    size at its MOST RECENT position only — range sums are then exactly
    'unique bytes accessed since', the byte-weighted reuse distance."""

    def __init__(self, n: int):
        self.n = n
        self.t = [0] * (n + 1)

    def add(self, i: int, v: int) -> None:
        i += 1
        while i <= self.n:
            self.t[i] += v
            i += i & -i

    def prefix(self, i: int) -> int:
        """Sum of positions [0, i)."""
        s = 0
        while i > 0:
            s += self.t[i]
            i -= i & -i
        return s

    def range(self, lo: int, hi: int) -> int:
        """Sum of positions [lo, hi)."""
        return self.prefix(hi) - self.prefix(lo)


def ghost_lru_curve(stream: list, budgets: list) -> dict:
    """Simulate an LRU cache of compressed pages at every budget in ONE
    pass over the access stream.

    stream: [(key_id, encoded_bytes, moved_bytes)] oldest-first.
    budgets: candidate HBM budgets in bytes.

    Per access, the byte-weighted reuse distance (unique encoded bytes
    touched since this page's previous access, including the page
    itself) decides hit/miss at every budget at once: hit iff
    distance <= budget. Cold first accesses miss everywhere (the first
    ship is unavoidable). Because the same distance is compared against
    every budget, miss bytes are monotone non-increasing in budget —
    the stack-algorithm property, by construction.

    Returns {"totalMovedBytes", "accesses", "curve": [{budgetBytes,
    missBytes, savedBytes, missRatio, savedRatio}, ...]} with the curve
    sorted by ascending budget.
    """
    budgets = sorted(int(b) for b in budgets)
    n = len(stream)
    miss = {b: 0 for b in budgets}
    total_moved = 0
    bit = _Fenwick(n)
    last_pos: dict[int, tuple] = {}  # kid -> (pos, enc recorded there)
    for t, (kid, enc, moved) in enumerate(stream):
        total_moved += moved
        prev = last_pos.get(kid)
        if prev is None:
            dist = None  # cold: misses at every budget
        else:
            p, p_enc = prev
            bit.add(p, -p_enc)  # this key's bytes move to position t
            dist = bit.range(p + 1, t) + enc
        bit.add(t, enc)
        last_pos[kid] = (t, enc)
        for b in budgets:
            if dist is None or dist > b:
                miss[b] += moved
            else:
                break  # budgets ascend: a hit at b is a hit at every larger b
    curve = []
    prev_miss = None
    for b in budgets:
        m = miss[b]
        # belt-and-braces: the loop's early break preserves monotonicity
        # exactly, but clamp anyway so a future edit can't ship a
        # non-monotone curve
        if prev_miss is not None:
            m = min(m, prev_miss)
        prev_miss = m
        curve.append({
            "budgetBytes": b,
            "missBytes": m,
            "savedBytes": total_moved - m,
            "missRatio": round(m / max(total_moved, 1), 4),
            "savedRatio": round((total_moved - m) / max(total_moved, 1), 4),
        })
    return {
        "totalMovedBytes": total_moved,
        "accesses": n,
        "curve": curve,
    }


def default_budgets(unique_encoded_bytes: int) -> list:
    """(label, bytes) pairs at the fixed working-set fractions."""
    u = max(int(unique_encoded_bytes), 1)
    return [(label, max(1, int(u * f))) for label, f in BUDGET_FRACTIONS]


def what_if_report(ledger: PageHeatLedger | None = None,
                   budgets_bytes: list | None = None,
                   publish_gauges: bool = False) -> dict:
    """Ghost-LRU curve over the ledger's current access stream at the
    default working-set-fraction budgets (or explicit byte budgets)."""
    ledger = ledger or LEDGER
    stream = ledger.access_stream()
    # unique working set from current entries (not the stream, which may
    # hold evicted pages' history)
    with ledger._lock:
        unique_enc = sum(e[2] for e in ledger._entries.values())
    if budgets_bytes is not None:
        labelled = [(str(b), int(b)) for b in budgets_bytes]
    else:
        labelled = default_budgets(unique_enc)
    sim = ghost_lru_curve(stream, [b for _, b in labelled])
    by_bytes = {c["budgetBytes"]: c for c in sim["curve"]}
    curve = []
    for label, b in sorted(labelled, key=lambda lb: lb[1]):
        row = {"budget": label, **by_bytes[b]}
        curve.append(row)
    if publish_gauges and budgets_bytes is None:
        for row in curve:
            miss_ratio_gauge.set(row["missRatio"], budget=row["budget"])
            budget_bytes_gauge.set(row["budgetBytes"], budget=row["budget"])
    return {
        "uniqueEncodedBytes": unique_enc,
        "totalMovedBytes": sim["totalMovedBytes"],
        "accesses": sim["accesses"],
        "budgetsBytes": [b for _, b in sorted(labelled, key=lambda lb: lb[1])],
        "curve": curve,
    }


# ---------------------------------------------------------------------------
# admission API: the closed loop the device-resident hot tier consumes
# ---------------------------------------------------------------------------


def knee_budget(curve: list) -> int:
    """Budget at the KNEE of a what-if curve (rows with `budgetBytes`
    and `savedBytes`): the point of maximum vertical distance between
    the normalized saved-bytes curve and the straight chord from the
    smallest to the largest budget — past the knee each extra HBM byte
    buys less than the average byte did, so pinning beyond it trades
    headroom for a flattening return. Returns 0 when the curve saves
    nothing anywhere (a cold ledger must admit nothing)."""
    rows = [r for r in curve if r.get("budgetBytes", 0) > 0]
    if not rows:
        return 0
    max_saved = max(int(r.get("savedBytes", 0)) for r in rows)
    if max_saved <= 0:
        return 0
    max_budget = max(int(r["budgetBytes"]) for r in rows)
    best, best_d = 0, float("-inf")
    for r in rows:
        d = (int(r.get("savedBytes", 0)) / max_saved
             - int(r["budgetBytes"]) / max_budget)
        # ties break toward the SMALLER budget (strict >): same savings
        # for less HBM
        if d > best_d:
            best_d, best = d, int(r["budgetBytes"])
    return best


def admission_candidates(budget_bytes: int,
                         ledger: PageHeatLedger | None = None,
                         min_ships: int = 2,
                         tenant_weights: dict | None = None) -> list:
    """The pages the hot tier SHOULD hold at `budget_bytes`: ledger
    entries ranked by re-ship bytes (optionally weighted by the
    per-tenant scan-cost vectors — a tenant whose scans dominate the
    bill pulls its pages up), greedily packed by encoded (pinned) size.
    Pages that shipped fewer than `min_ships` times, or whose re-ship
    total never exceeded their pinned cost, are never worth a slot.

    Returns [{"block", "column", "offset", "ships", "movedBytes",
    "encodedBytes"}] hottest-first; the tier treats membership as its
    admission set."""
    ledger = ledger or LEDGER
    with ledger._lock:
        entries = {k: list(e) for k, e in ledger._entries.items()}
    rows = []
    for k, e in entries.items():
        ships, moved, enc = e[0], e[1], e[2]
        if ships < min_ships or enc <= 0 or moved <= enc:
            continue
        w = 1.0
        if tenant_weights:
            w = float(tenant_weights.get(k[0], tenant_weights.get("*", 1.0)))
        rows.append((moved * w, k, ships, moved, enc))
    rows.sort(key=lambda r: -r[0])
    out, pinned = [], 0
    for _w, k, ships, moved, enc in rows:
        if pinned + enc > budget_bytes:
            continue  # keep packing: a smaller page may still fit
        pinned += enc
        out.append({
            "block": k[0], "column": k[1], "offset": k[2],
            "ships": ships, "movedBytes": moved, "encodedBytes": enc,
        })
    return out


def admission_report(budget_bytes: int | None = None,
                     ledger: PageHeatLedger | None = None,
                     min_ships: int = 2) -> dict:
    """One admission decision, explained: the what-if knee, the
    effective budget (knee capped by the configured tier budget when
    given), and the candidate set at that budget — what `cli analyse
    device --resident` and the tier's refresh both read."""
    ledger = ledger or LEDGER
    report = what_if_report(ledger=ledger)
    knee = knee_budget(report["curve"])
    effective = knee if budget_bytes is None else min(knee, int(budget_bytes))
    cands = admission_candidates(effective, ledger=ledger, min_ships=min_ships)
    return {
        "kneeBudgetBytes": knee,
        "configuredBudgetBytes": budget_bytes,
        "effectiveBudgetBytes": effective,
        "candidates": cands,
        "candidateBytes": sum(c["encodedBytes"] for c in cands),
    }


def device_report(budgets_bytes: list | None = None, top: int = 50) -> dict:
    """The /status/device document: transfer counters + hot-set report +
    what-if miss-ratio curve + the resident hot tier's actual state,
    one correlated view of data movement."""
    from tempo_tpu_torch.encoding.vtpu import colcache
    from tempo_tpu_torch.util import devicetiming

    return {
        "transfer": devicetiming.transfer_report(),
        "pageHeat": LEDGER.snapshot(top=top),
        "whatIf": what_if_report(budgets_bytes=budgets_bytes,
                                 publish_gauges=budgets_bytes is None),
        "residentTier": colcache.device_tier_report(),
    }


# ---------------------------------------------------------------------------
# periodic export (StorageScanner-style)
# ---------------------------------------------------------------------------


class PageHeatExporter:
    """Background refresher: recomputes the what-if curve into the
    per-budget gauges on an interval and, when `export_dir` (or
    TEMPO_TPU_PAGEHEAT_EXPORT_DIR) is set, writes a JSON snapshot the
    offline `cli analyse device` replays — the measured-not-asserted
    input the hot tier's sizing rests on. One owner per process is enough;
    App starts it wherever a storage engine lives."""

    SNAPSHOT_NAME = "device_ledger.json"
    _KEEP = 5
    _EXPORT_STREAM_CAP = 16384  # newest accesses carried in the snapshot

    def __init__(self, interval_s: float | None = None,
                 export_dir: str | None = None):
        env_s = os.environ.get("TEMPO_TPU_PAGEHEAT_EXPORT_S", "")
        self.interval_s = interval_s if interval_s is not None else (
            float(env_s) if env_s else 300.0)
        self.export_dir = export_dir or os.environ.get(
            "TEMPO_TPU_PAGEHEAT_EXPORT_DIR") or None
        self.last: dict | None = None
        self.last_path: str | None = None
        self._stop = threading.Event()
        self._thread = None

    def export_once(self) -> dict:
        doc = self.build_snapshot()
        self.last = doc
        if self.export_dir:
            try:
                os.makedirs(self.export_dir, exist_ok=True)
                name = f"device_ledger-{int(doc['exportedAt'])}.json"
                path = os.path.join(self.export_dir, name)
                with open(path, "w") as f:
                    json.dump(doc, f)
                latest = os.path.join(self.export_dir, self.SNAPSHOT_NAME)
                tmp = latest + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                os.replace(tmp, latest)  # atomic "latest" pointer
                self.last_path = path
                self._prune()
            except OSError:
                log.exception("pageheat snapshot export failed")
        return doc

    def build_snapshot(self) -> dict:
        """Self-contained snapshot: ledger rollup + what-if curve + the
        raw access stream (key-interned), so offline analysis can re-run
        the simulation at different budgets."""
        from tempo_tpu_torch.encoding.vtpu import colcache

        stream = LEDGER.access_stream()[-self._EXPORT_STREAM_CAP:]
        keys = LEDGER.key_table()
        used = sorted({kid for kid, _, _ in stream})
        index = {kid: i for i, kid in enumerate(used)}
        return {
            "exportedAt": time.time(),
            "seq": LEDGER.mark(),
            "pageHeat": LEDGER.snapshot(top=200),
            "whatIf": what_if_report(publish_gauges=True),
            "residentTier": colcache.device_tier_report(),
            "keys": [list(keys.get(kid, ("?", "?", -1))) for kid in used],
            "stream": [[index[kid], enc, mv] for kid, enc, mv in stream],
        }

    def _prune(self) -> None:
        try:
            snaps = sorted(
                p for p in os.listdir(self.export_dir)
                if p.startswith("device_ledger-") and p.endswith(".json")
            )
            for stale in snaps[: -self._KEEP]:
                os.remove(os.path.join(self.export_dir, stale))
        except OSError:
            pass

    def start(self) -> "PageHeatExporter":
        if self._thread is not None:
            return self

        def loop():
            delay = min(30.0, self.interval_s)
            while not self._stop.wait(delay):
                delay = self.interval_s
                try:
                    self.export_once()
                except Exception:
                    log.exception("pageheat export failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pageheat-export")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def analyse_snapshot(doc: dict, budgets_mb: list | None = None) -> dict:
    """Offline analysis over an exported snapshot: the same hot-set +
    what-if answer /status/device serves live, optionally re-simulated
    at explicit --budgets-mb (the ledger snapshot carries its access
    stream precisely so budgets can be explored after the fact)."""
    out = {
        "exportedAt": doc.get("exportedAt"),
        "pageHeat": doc.get("pageHeat", {}),
        "whatIf": doc.get("whatIf", {}),
    }
    stream = [tuple(row) for row in doc.get("stream", [])]
    if budgets_mb and stream:
        budgets = [int(float(mb) * (1 << 20)) for mb in budgets_mb]
        sim = ghost_lru_curve(stream, budgets)
        out["whatIf"] = {
            "totalMovedBytes": sim["totalMovedBytes"],
            "accesses": sim["accesses"],
            "budgetsBytes": budgets,
            "curve": [{"budget": f"{c['budgetBytes'] / (1 << 20):g}MB", **c}
                      for c in sim["curve"]],
        }
    return out
