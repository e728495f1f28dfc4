"""Shared encoding contracts and config.

Port of tempo_tpu/encoding/common.py (BlockConfig, CompactionOptions,
SearchRequest, TraceSearchMetadata, SearchResponse, with the wire forms
the frontend<->querier jobs carry). CompactionOptions.mesh is a
parallel/mesh.Mesh (or None: one device), and payload_plane "device"
needs one.

Reference: tempodb/encoding/common/interfaces.go:58-97 (BackendBlock,
WALBlock, Compactor, CompactionOptions) and config.go:10 (BlockConfig:
bloom FP, index/row-group sizing). The TPU twist: BlockConfig also pins
the static-shape bucketing for device kernels (row groups are padded to
the nearest bucket so XLA compiles a bounded set of kernel shapes).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BlockConfig:
    version: str = "vtpu1"
    bloom_fp: float = 0.01
    bloom_shard_size_bytes: int = 100 * 1024
    # row-group sizing: split at trace boundaries near this many spans
    row_group_spans: int = 1 << 15
    codec: str = "auto"  # column codec: auto | none | zlib | zstd | zstd_shuffle (auto = zstd_shuffle when the native C++ lib builds, else zlib)
    hll_precision: int = 12
    # shape buckets for device kernels: pad-to-power-of-two within [min,max]
    min_device_bucket: int = 1 << 10
    # step-partial downsampling rules (standing/rules.py): per block,
    # pre-bucketed (series, step-bin) count columns are written for each
    # rule — (name, filter-less metrics query, step seconds, series
    # ceiling) — and a matching query_range reads them instead of span
    # columns. () disables the tier.
    step_partial_rules: tuple = (
        ("rate_by_service", "{} | rate() by (resource.service.name)", 60, 512),
        ("duration_hist", "{} | histogram_over_time(duration)", 60, 1),
    )

    def bucket_for(self, n: int) -> int:
        """Static kernel shape for an n-row group (next pow2, floored)."""
        b = self.min_device_bucket
        while b < n:
            b <<= 1
        return b


@dataclass
class CompactionOptions:
    """Reference: common.CompactionOptions (interfaces.go:58-76)."""

    chunk_size_bytes: int = 4 * 1024 * 1024
    flush_size_bytes: int = 20 * 1024 * 1024
    output_blocks: int = 1
    block_config: BlockConfig = field(default_factory=BlockConfig)
    # per-tenant cap: spans above this per trace are dropped + counted
    # (reference: max_bytes_per_trace enforcement during compaction,
    #  vparquet/compactor.go:96-111 — ours is span-count based since rows
    #  are spans)
    max_spans_per_trace: int = 0
    on_spans_dropped: object = None  # callback(n_dropped)
    # device mesh (parallel/mesh.Mesh) for sharded compaction: tiles are
    # ID-range-sharded over its devices and block sketches merge over its
    # range axis (encoding/vtpu/compactor.py); None = one device
    mesh: object = None
    # tile merge planner: auto (native C++ k-way when built, else
    # device), native, device (single-device lexsort on the compactor's
    # device) or numpy (the single-threaded host mirror)
    merge_path: str = "auto"
    # where payload columns live during a mesh-sharded merge: "host"
    # (perm/keep fetched per tile, columns gathered in numpy) or "device"
    # (merged rows gathered on the shards' devices, fetched once a flush)
    payload_plane: str = "host"
    # zero-decode fast path (host merge only): row groups whose trace-ID
    # range overlaps no other input block relocate their compressed
    # pages verbatim (byte copy + page-index offset rewrite) instead of
    # decode->gather->re-encode; dictionary-coded columns re-encode only
    # under a non-identity dictionary remap (lazy column gather). False
    # forces the full re-encode path everywhere (the bench's slow arm).
    zero_decode: bool = True


@dataclass
class SearchRequest:
    """Parsed search parameters (reference: pkg/api/http.go ParseSearchRequest).

    tags: exact-match key->value (string) pairs; special keys name and
    service map to intrinsics (matching the reference's handling of
    well-known tags in vparquet/block_search.go).
    """

    tags: dict = field(default_factory=dict)
    min_duration_ns: int = 0
    max_duration_ns: int = 0  # 0 = unbounded
    start_seconds: int = 0
    end_seconds: int = 0  # 0 = unbounded
    limit: int = 20  # 0 = unbounded (matches the reference's semantics)
    query: str = ""  # raw TraceQL, handled by the traceql engine

    def to_dict(self) -> dict:
        """Wire form for the frontend<->querier job protocol (reference:
        pkg/api request (de)serialization between shards and queriers)."""
        import dataclasses

        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SearchRequest":
        import dataclasses

        known = {f.name for f in dataclasses.fields(SearchRequest)}
        return SearchRequest(**{k: v for k, v in d.items() if k in known})


@dataclass
class TraceSearchMetadata:
    """One search hit (reference: tempopb.TraceSearchMetadata)."""

    trace_id_hex: str
    root_service_name: str = ""
    root_trace_name: str = ""
    start_time_unix_nano: int = 0
    duration_ms: int = 0
    # TraceQL results carry the matched spanset through the frontend
    # (reference: tempopb.TraceSearchMetadata.SpanSet)
    span_set: dict | None = None

    def to_dict(self) -> dict:
        d = {
            "traceID": self.trace_id_hex,
            "rootServiceName": self.root_service_name,
            "rootTraceName": self.root_trace_name,
            "startTimeUnixNano": str(self.start_time_unix_nano),
            "durationMs": self.duration_ms,
        }
        if self.span_set is not None:
            d["spanSet"] = self.span_set
        return d


@dataclass
class SearchResponse:
    traces: list = field(default_factory=list)  # TraceSearchMetadata
    inspected_bytes: int = 0
    # column value bytes materialized into row space by decode work —
    # with run/dict-space evaluation this tracks the selectivity (the
    # surviving bytes), not the row count; the ROADMAP north-star is
    # inspectedBytes ≈ decodedBytes ≈ transferred bytes
    decoded_bytes: int = 0
    inspected_traces: int = 0
    inspected_blocks: int = 0
    # read-path economy (zone maps + coalescing): row groups skipped
    # with zero backend reads / backend round trips saved by coalesced
    # page reads — per query, so the pruning win is auditable alongside
    # inspectedBytes
    pruned_row_groups: int = 0
    coalesced_reads: int = 0
    # graceful degradation: "complete" | "partial". The frontend marks a
    # response partial when terminal shard failures stayed within the
    # tenant's failed-shard budget (failed_shards counts them); a partial
    # response may be missing matching traces from the failed shards and
    # clients must surface that (reference analog: the search SLO mixin's
    # partial-result accounting)
    status: str = "complete"
    failed_shards: int = 0
    # execution waterfall (util/stagetimings): stage -> seconds, merged
    # shard-wise by the frontend; empty until the frontend attaches it
    stage_seconds: dict = field(default_factory=dict)
    device_dispatches: int = 0

    def merge(self, other: "SearchResponse", limit: int = 0) -> None:
        seen = {t.trace_id_hex for t in self.traces}
        for t in other.traces:
            if t.trace_id_hex not in seen:
                self.traces.append(t)
                seen.add(t.trace_id_hex)
        self.traces.sort(key=lambda t: -t.start_time_unix_nano)
        if limit:
            self.traces = self.traces[:limit]
        self.inspected_bytes += other.inspected_bytes
        self.decoded_bytes += other.decoded_bytes
        self.inspected_traces += other.inspected_traces
        self.inspected_blocks += other.inspected_blocks
        self.pruned_row_groups += other.pruned_row_groups
        self.coalesced_reads += other.coalesced_reads
        if other.status == "partial":
            self.status = "partial"
        self.failed_shards += other.failed_shards
        for k, v in other.stage_seconds.items():
            self.stage_seconds[k] = self.stage_seconds.get(k, 0.0) + v
        self.device_dispatches += other.device_dispatches

    def to_dict(self) -> dict:
        d = {
            "traces": [t.to_dict() for t in self.traces],
            "metrics": {
                "inspectedTraces": self.inspected_traces,
                "inspectedBytes": str(self.inspected_bytes),
                "decodedBytes": str(self.decoded_bytes),
                "inspectedBlocks": self.inspected_blocks,
                "prunedRowGroups": self.pruned_row_groups,
                "coalescedReads": self.coalesced_reads,
            },
        }
        if self.status != "complete":
            # added only when degraded so complete responses stay
            # byte-identical to the pre-partial wire form
            d["status"] = self.status
            d["metrics"]["failedShards"] = self.failed_shards
        if self.stage_seconds:
            # only the frontend's final merge carries a waterfall; block
            # and worker partials stay byte-identical to the old wire
            d["metrics"]["stageSeconds"] = {
                k: round(v, 6) for k, v in self.stage_seconds.items()
            }
            d["metrics"]["deviceDispatches"] = self.device_dispatches
        return d

    @staticmethod
    def from_dict(doc: dict) -> "SearchResponse":
        resp = SearchResponse()
        for t in doc.get("traces", []):
            resp.traces.append(
                TraceSearchMetadata(
                    trace_id_hex=t["traceID"],
                    root_service_name=t.get("rootServiceName", ""),
                    root_trace_name=t.get("rootTraceName", ""),
                    start_time_unix_nano=int(t.get("startTimeUnixNano", "0")),
                    duration_ms=t.get("durationMs", 0),
                )
            )
        m = doc.get("metrics", {})
        resp.inspected_traces = m.get("inspectedTraces", 0)
        resp.inspected_bytes = int(m.get("inspectedBytes", "0"))
        resp.decoded_bytes = int(m.get("decodedBytes", "0"))
        resp.inspected_blocks = m.get("inspectedBlocks", 0)
        resp.pruned_row_groups = m.get("prunedRowGroups", 0)
        resp.coalesced_reads = m.get("coalescedReads", 0)
        resp.status = doc.get("status", "complete")
        resp.failed_shards = m.get("failedShards", 0)
        resp.stage_seconds = {
            str(k): float(v) for k, v in (m.get("stageSeconds") or {}).items()
        }
        resp.device_dispatches = int(m.get("deviceDispatches", 0))
        return resp
