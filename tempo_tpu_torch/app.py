"""App wiring — single-binary and per-role composition on one device.

Port of tempo_tpu/app.py (reference: cmd/tempo/app, the module manager
DAG modules.go:369-423). target="all" builds every role in-process over
one ring and one storage engine. Any other target of ROLES builds ONE
role; roles find each other through the ring KV (ring_kv_path: FileKV
on one host; ring_kv_url: modules/netkv's KV served on a role's own
listener) and talk over the /rpc/v1 HTTP protocol (modules/rpc), the
reference's gRPC seam, with the reference's bytes on the wire.

`App(cfg, device=None)` resolves the device once (CUDA unless "cpu" is
passed; raises without CUDA, whatever the target) and hands it to every
TempoDB it builds, to the device tier, to the standing-query engine and
to the metrics-generator, so the blocks' sketch plane, the metrics
accumulator, the standing fold, the ingest tail parked at each cut (with
its resident fold and live-tail scan), the service graphs' sketches and
the graph queries' critical paths run on that device from any worker,
cut or remote-worker thread. On target all and compactor it starts the
storage analytics scanner (db/analytics) every
`storage.trace.analytics_scan_s`, as the reference does, and, when their
sections enable them, the in-process vulture (vulture.py; the sidecar
on target=vulture), the burn-rate SLO engine (util/slo), the auto-RCA
engine (rca/), which subscribes to the SLO engine's page burns and the
standing engine's deviations, and the generator's remote write
(modules/generator/storage). A distributor tees each push to the
tenant's forwarders (modules/forwarder) when `forwarders` names some,
which forces the object ingest path (can_push_spans); `usage_report`
starts the anonymous usage reporter (usagestats) on target all, and
`self_tracing` installs util/tracing's SelfTraceExporter: a process
with a distributor pushes its own finished traces into itself under
`_self_`, any other role ships them by OTLP/HTTP to
`self_tracing.endpoint`.

AppConfig keeps every field of the reference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import torch

from tempo_tpu_torch import device as _device
from tempo_tpu_torch.compiled import cache as compiled_cache
from tempo_tpu_torch.compiled.cache import CompiledConfig
from tempo_tpu_torch.config_sections import DeviceTierConfig
from tempo_tpu_torch.db import DBConfig, TempoDB
from tempo_tpu_torch.encoding.vtpu.colcache import configure_device_tier
from tempo_tpu_torch.encoding.common import SearchRequest
from tempo_tpu_torch.modules.compactor_module import CompactorModule
from tempo_tpu_torch.modules.distributor import Distributor
from tempo_tpu_torch.modules.frontend import Frontend, FrontendConfig
from tempo_tpu_torch.modules.generator import Generator
from tempo_tpu_torch.modules.generator.storage import RemoteWriteStorage
from tempo_tpu_torch.modules.ingester import Ingester, IngesterConfig
from tempo_tpu_torch.modules.netkv import KVService
from tempo_tpu_torch.modules.overrides import Limits, Overrides
from tempo_tpu_torch.modules.querier import Querier
from tempo_tpu_torch.modules.ring import FileKV, MemoryKV, Ring
from tempo_tpu_torch.modules.rpc import (
    RemoteGenerator,
    RemoteIngester,
    RingClientPool,
    RPCHandler,
)
from tempo_tpu_torch.modules.worker import JobBroker, LocalWorkerPool, RemoteWorker
from tempo_tpu_torch.rca import RCAConfig, RCAEngine
from tempo_tpu_torch.util import devicetiming  # noqa: F401 — registers the
# device-dispatch histograms so /metrics exposes them from boot, not
# from the first dispatch
from tempo_tpu_torch.standing import StandingConfig, StandingEngine
from tempo_tpu_torch.util import resource, slo, tracing
from tempo_tpu_torch.util.circuit import CircuitBreaker
from tempo_tpu_torch.vulture import VultureConfig

log = logging.getLogger(__name__)

DEFAULT_TENANT = "single-tenant"  # reference: util.FakeTenantID for non-multitenant

ROLES = (
    "all",
    "distributor",
    "ingester",
    "querier",
    "query-frontend",
    "compactor",
    "metrics-generator",
    "vulture",
)

@dataclass
class AppConfig:
    target: str = "all"
    multitenancy_enabled: bool = False
    db: DBConfig = field(default_factory=DBConfig)
    ingester: IngesterConfig = field(default_factory=IngesterConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    limits: Limits = field(default_factory=Limits)
    overrides_path: str | None = None
    replication_factor: int = 1
    n_ingesters: int = 1  # in-process ingesters (tests use >1 to exercise RF)
    query_workers: int = 4
    generator_enabled: bool = True
    # remote-write of generator metrics (reference: modules/generator/storage);
    # None or an endpoint-less config disables shipping
    remote_write: "RemoteWriteConfig | None" = None
    # configured forwarders; tenants opt in via overrides `forwarders`
    forwarders: list = field(default_factory=list)  # list[ForwarderConfig]
    # anonymous usage reporting (reference: pkg/usagestats; off by default)
    usage_stats: "object | None" = None  # usagestats.UsageStatsConfig
    # -- microservices mode (any target != all) -------------------------
    instance_id: str = ""  # this process's ring identity
    ring_kv_path: str = ""  # shared ring state file (FileKV) for one-host clusters
    # networked ring KV (reference: memberlist/consul/etcd KV): "local"
    # serves + uses this process's own /kv/v1 store; an http://host:port
    # URL points the rings at the serving role. Takes precedence over
    # ring_kv_path, so multi-node clusters need no shared filesystem.
    ring_kv_url: str = ""
    advertise_addr: str = ""  # http://host:port other roles reach us at
    frontend_address: str = ""  # queriers: frontend to pull jobs from
    # ring health: instances missing heartbeats this long are excluded
    # from replica sets (reference: dskit ring HeartbeatTimeout)
    ring_heartbeat_timeout_s: float = 60.0
    # overload control plane budgets (util/resource): pools + watermarks
    # that drive the process pressure level and admission gates
    resource: "resource.ResourceConfig" = field(
        default_factory=resource.ResourceConfig
    )
    # self-observability dogfood loop (util/tracing.SelfTracingConfig):
    # when enabled, the process exports its own spans into its own
    # ingest path under the reserved `_self_` tenant — sampled and
    # rate-bounded, dropped entirely under memory pressure
    self_tracing: "tracing.SelfTracingConfig" = field(
        default_factory=tracing.SelfTracingConfig
    )
    # continuous-verification prober (vulture.py): enabled=True arms it
    # in-process on target=all; `-target=vulture` builds the HTTP
    # sidecar against vulture.target
    vulture: "VultureConfig" = field(default_factory=VultureConfig)
    # burn-rate SLO engine (util/slo.py): SLIs over this process's own
    # counters -> tempo_tpu_slo_* gauges + /status/slo
    slo: "slo.SLOConfig" = field(default_factory=slo.SLOConfig)
    # standing-query engine (tempo_tpu_torch/standing): registered query_range
    # queries fold each ingest cut's delta into per-query accumulators
    # (O(new spans) per evaluation); lives beside the ingesters
    standing: "StandingConfig" = field(default_factory=StandingConfig)
    # device-resident hot tier (encoding/vtpu/colcache.DeviceTier):
    # budget_mb > 0 pins the hottest compressed pages in accelerator
    # memory; scans over them skip fetch+decode+h2d entirely
    device_tier: "DeviceTierConfig" = field(default_factory=DeviceTierConfig)
    # compiled-query tier (tempo_tpu_torch/compiled): shape-keyed fused device
    # programs for simple-count metrics plans; kill switch
    # TEMPO_TPU_COMPILED=0 or compiled.enabled=false
    compiled: "CompiledConfig" = field(default_factory=CompiledConfig)
    # auto-RCA incident engine (tempo_tpu_torch/rca): SLO fast-burn and
    # standing-deviation triggers open machine-written incident records
    # with a typed, evidence-backed root cause
    rca: "RCAConfig" = field(default_factory=RCAConfig)


class RoleUnavailable(RuntimeError):
    """API called on a process whose role doesn't serve it."""


class App:
    def __init__(self, cfg: AppConfig, device=None):
        target = cfg.target or "all"
        if target not in ROLES:
            raise ValueError(f"unknown target {target!r} (have {ROLES})")
        dev = _device.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.cfg = cfg
        # (re)apply the overload budgets to the process-wide governor —
        # pools persist across App rebuilds (modules hold references),
        # only the limits/watermarks move
        self.governor = resource.configure(cfg.resource)
        # install (or disable) the device-resident hot tier on this App's
        # device; it binds to the governor lazily, so order relative to
        # configure() is free. The tier is process-wide: role Apps that
        # share a process share it, as in the reference
        configure_device_tier(cfg.device_tier, device=self.device)
        # apply the compiled-tier section (and register its counters on
        # the boot path, so /metrics exposes them before the first query)
        compiled_cache.configure(cfg.compiled)
        self.target = target

        # members default to absent; the role builder fills its slice
        self.db = None
        self.overrides = Overrides(cfg.limits, cfg.overrides_path)
        self.ring = None
        self.generator_ring = None
        self.ingesters: dict = {}
        self.generator = None
        self.distributor = None
        self.querier = None
        self.broker = None
        self.workers = None
        self.remote_worker = None
        self.frontend = None
        self.compactor = None
        self.forwarder_manager = None
        self.remote_write_storage = None
        self.usage_reporter = None
        self.storage_scanner = None
        self.pageheat_exporter = None
        self.rpc = None
        self._heartbeat_stops = []
        self._registered: list = []  # (ring, instance_id) to unregister on shutdown
        # every role serves the ring KV on its HTTP listener; peers point
        # ring_kv_url at whichever role is designated (reference: one
        # KVInitService shared by all rings, modules.go:297-325)
        self.kv_service = KVService()
        self._net_kvs: list = []

        self._self_exporter = None
        self._self_export_client = None
        self.vulture = None
        self.slo_engine = None
        # built BEFORE the ingesters so the cut path holds a stable
        # reference; storage/WAL wiring attaches after the role build
        self.standing = (
            StandingEngine(cfg.standing, overrides=self.overrides,
                           governor=self.governor, device=self.device)
            if cfg.standing.enabled and target in ("all", "ingester") else None
        )
        if target == "all":
            self._build_all()
        else:
            self._build_role(target)
        self._maybe_standing_attach()
        self._maybe_self_tracing()
        self._maybe_storage_scanner()
        self._maybe_pageheat_exporter()
        self._maybe_vulture()
        if cfg.slo.enabled:
            self.slo_engine = slo.SLOEngine(cfg.slo)
        self.rca = None
        self._maybe_rca()

    def _maybe_rca(self):
        """Auto-RCA incident engine: subscribes to the SLO evaluator's
        page-burn transitions and the standing engine's deviation fires.
        Evidence collection runs queries through this App's frontend, so
        the all-in-one target is the natural host; other roles get the
        triggers they can serve evidence for."""
        if not self.cfg.rca.enabled:
            return
        self.rca = RCAEngine(self.cfg.rca, self)
        if self.slo_engine is not None:
            self.slo_engine.subscribe(self.rca.on_slo_burn)
        if self.standing is not None:
            self.standing.subscribe_deviations(self.rca.on_deviation)

    # ------------------------------------------------------------------
    def _hb_period(self) -> float:
        return min(10.0, max(0.5, self.cfg.ring_heartbeat_timeout_s / 3))

    def _ring_kv(self, suffix: str = ""):
        if self.cfg.ring_kv_url == "local":
            from tempo_tpu_torch.modules.netkv import LocalKV

            return LocalKV(self.kv_service, f"ring{suffix}")
        if self.cfg.ring_kv_url:
            from tempo_tpu_torch.modules.netkv import HttpKV

            kv = HttpKV(self.cfg.ring_kv_url, f"ring{suffix}")
            self._net_kvs.append(kv)
            return kv
        if not self.cfg.ring_kv_path:
            raise ValueError(
                f"target={self.target} requires ring_kv_path or ring_kv_url"
            )
        return FileKV(self.cfg.ring_kv_path + suffix)

    def _instance_id(self, default: str) -> str:
        return self.cfg.instance_id or default

    def _make_db(self) -> TempoDB:
        return TempoDB(self.cfg.db, device=self.device)

    def _query_breaker(self):
        """Shared breaker around query-job execution: a sustained
        backend outage opens it after 10 consecutive job failures
        (transient chaos-level flakes never string 10 in a row), after
        which every retry fails fast instead of re-hammering the backend
        until a half-open probe succeeds."""
        return CircuitBreaker(name="query-backend", failure_threshold=10,
                              reset_timeout_s=5.0)

    def _maybe_forwarders(self):
        """The distributor's forwarder tee: one queue and worker set a
        configured forwarder (modules/forwarder)."""
        if self.cfg.forwarders:
            from tempo_tpu_torch.modules.forwarder import ForwarderManager

            self.forwarder_manager = ForwarderManager(self.cfg.forwarders, self.overrides)

    def _maybe_remote_write(self):
        """The generator's series leave by Prometheus remote write when
        metrics_generator.remote_write names an endpoint."""
        rw = self.cfg.remote_write
        if rw is not None and rw.endpoint:
            self.remote_write_storage = RemoteWriteStorage(rw)

    # ------------------------------------------------------------------
    def _build_all(self):
        cfg = self.cfg
        self.db = self._make_db()
        kv = MemoryKV()
        self.ring = Ring(kv, replication_factor=cfg.replication_factor,
                         heartbeat_timeout_s=cfg.ring_heartbeat_timeout_s)

        for i in range(cfg.n_ingesters):
            iid = f"ingester-{i}"
            # each in-process ingester gets its own WAL subdir (separate
            # process-equivalents must not share head blocks)
            sub_cfg = DBConfig(**{**cfg.db.__dict__})
            sub_cfg.wal_path = (cfg.db.wal_path or "wal") + f"/{iid}"
            ing_db = TempoDB(sub_cfg, raw_backend=self.db.backend.raw,
                             device=self.device)
            ing_db.blocklist = self.db.blocklist  # shared world view
            ing = Ingester(ing_db, self.overrides, cfg.ingester, instance_id=iid,
                           standing=self.standing)
            self.ingesters[iid] = ing
            self.ring.register(iid)
            self._registered.append((self.ring, iid))
            self._heartbeat_stops.append(self.ring.start_heartbeat(iid, period_s=self._hb_period()))

        gen_clients = {}
        if cfg.generator_enabled:
            self.generator_ring = Ring(MemoryKV(), replication_factor=1)
            self.generator = Generator(self.overrides, instance_id="generator-0",
                                       device=self.device)
            self.generator_ring.register("generator-0")
            gen_clients["generator-0"] = self.generator
            self._heartbeat_stops.append(self.generator_ring.start_heartbeat(
                "generator-0", period_s=self._hb_period()))
            self._maybe_remote_write()

        self._maybe_forwarders()
        self.distributor = Distributor(self.ring, ingester_clients=self.ingesters,
                                       overrides=self.overrides,
                                       generator_ring=self.generator_ring,
                                       generator_clients=gen_clients,
                                       forwarder_manager=self.forwarder_manager)
        self.querier = Querier(self.db, self.ring, ingester_clients=self.ingesters)
        self.broker = JobBroker()
        self.workers = LocalWorkerPool(self.broker, self.querier, cfg.query_workers,
                                       breaker=self._query_breaker())
        self.frontend = Frontend(self.broker, self.db, cfg.frontend, self.overrides)
        self.compactor = CompactorModule(self.db, ring=None)
        self.rpc = RPCHandler(
            ingester=next(iter(self.ingesters.values()), None),
            generator=self.generator,
            broker=self.broker,
        )
        self._maybe_usage_reporter()

    # ------------------------------------------------------------------
    def _build_role(self, role: str):
        cfg = self.cfg
        if role == "ingester":
            iid = self._instance_id("ingester-0")
            sub_cfg = DBConfig(**{**cfg.db.__dict__})
            sub_cfg.wal_path = (cfg.db.wal_path or "wal") + f"/{iid}"
            self.db = TempoDB(sub_cfg, device=self.device)
            ing = Ingester(self.db, self.overrides, cfg.ingester, instance_id=iid,
                           standing=self.standing)
            self.ingesters[iid] = ing
            self.ring = Ring(self._ring_kv(), replication_factor=cfg.replication_factor,
                             heartbeat_timeout_s=cfg.ring_heartbeat_timeout_s)
            self.ring.register(iid, addr=cfg.advertise_addr)
            self._registered.append((self.ring, iid))
            self._heartbeat_stops.append(self.ring.start_heartbeat(iid, period_s=self._hb_period()))
            self.rpc = RPCHandler(ingester=ing)
            return

        if role == "metrics-generator":
            gid = self._instance_id("generator-0")
            self.generator = Generator(self.overrides, instance_id=gid, device=self.device)
            self.generator_ring = Ring(self._ring_kv("-generator"), replication_factor=1)
            self.generator_ring.register(gid, addr=cfg.advertise_addr)
            self._registered.append((self.generator_ring, gid))
            self._heartbeat_stops.append(self.generator_ring.start_heartbeat(gid, period_s=self._hb_period()))
            self._maybe_remote_write()
            self.rpc = RPCHandler(generator=self.generator)
            return

        if role == "distributor":
            self.ring = Ring(self._ring_kv(), replication_factor=cfg.replication_factor,
                             heartbeat_timeout_s=cfg.ring_heartbeat_timeout_s)
            gen_clients = {}
            if cfg.generator_enabled:
                self.generator_ring = Ring(self._ring_kv("-generator"), replication_factor=1)
                gen_clients = RingClientPool(self.generator_ring, RemoteGenerator)
            self._maybe_forwarders()
            self.distributor = Distributor(
                self.ring,
                ingester_clients=RingClientPool(self.ring, RemoteIngester),
                overrides=self.overrides,
                generator_ring=self.generator_ring,
                generator_clients=gen_clients,
                forwarder_manager=self.forwarder_manager,
            )
            self.rpc = RPCHandler()
            return

        if role == "querier":
            self.db = self._make_db()
            self.ring = Ring(self._ring_kv(), replication_factor=cfg.replication_factor,
                             heartbeat_timeout_s=cfg.ring_heartbeat_timeout_s)
            self.querier = Querier(
                self.db, self.ring, ingester_clients=RingClientPool(self.ring, RemoteIngester)
            )
            if cfg.frontend_address:
                self.remote_worker = RemoteWorker(
                    cfg.frontend_address, self.querier, n_threads=cfg.query_workers,
                    breaker=self._query_breaker(),
                ).start()
            self.rpc = RPCHandler()
            return

        if role == "query-frontend":
            self.db = self._make_db()
            self.broker = JobBroker()
            self.frontend = Frontend(self.broker, self.db, cfg.frontend, self.overrides)
            self.rpc = RPCHandler(broker=self.broker)
            return

        if role == "compactor":
            self.db = self._make_db()
            self.compactor = CompactorModule(self.db, ring=None)
            self.rpc = RPCHandler()
            return

        if role == "vulture":
            # sidecar deployment (reference: cmd/tempo-vulture beside the
            # cluster): pushes to vulture.target over OTLP/HTTP and reads
            # via vulture.query_target (frontend) — its own /metrics
            # listener exports the tempo_vulture_* families prometheus
            # scrapes, and slo.enabled here judges exactly those
            from tempo_tpu_torch.vulture import HTTPClient, Vulture

            vcfg = cfg.vulture
            target = vcfg.target or cfg.frontend_address
            if not target:
                raise ValueError(
                    "target=vulture requires vulture.target (cluster base URL)")
            client = HTTPClient(
                target,
                tenant=vcfg.tenant if cfg.multitenancy_enabled else None,
                query_url=vcfg.query_target or None,
            )
            self.vulture = Vulture(client, cfg=vcfg)
            self.rpc = RPCHandler()
            return

        raise AssertionError(role)

    def _maybe_standing_attach(self):
        """Late wiring of the standing engine: storage for restart
        rebuilds, the ingesters for the read tail / WAL replay, and the
        WAL root for the registration snapshot. Loads the snapshot and
        rebuilds restored accumulators exactly from step partials +
        the rescanned WAL."""
        if self.standing is None:
            return
        if not self.ingesters:
            self.standing = None  # engine serves nothing without a cut path
            return
        snap_dir = self.cfg.db.wal_path or "wal"
        self.standing.attach(db=self.db, ingesters=self.ingesters,
                             snapshot_dir=snap_dir)

    def _maybe_vulture(self):
        """In-process prober on the all-in-one target (the reference
        runs tempo-vulture as a sidecar; a single binary can dogfood it
        directly — vulture.enabled in config)."""
        if self.target != "all" or not self.cfg.vulture.enabled:
            return
        from tempo_tpu_torch.vulture import InProcessClient, Vulture

        # with multitenancy on, an org-less push/query would 401 every
        # probe
        client = InProcessClient(
            self,
            tenant=self.cfg.vulture.tenant if self.cfg.multitenancy_enabled
            else None,
        )
        self.vulture = Vulture(client, cfg=self.cfg.vulture)

    def _maybe_self_tracing(self):
        """Close the dogfood loop: the global tracer exports finished
        traces into the system's ingest path under the `_self_` tenant,
        so TraceQL / query_range over `_self_` answers "what is the
        engine doing to itself". A process with a distributor pushes
        locally; any other role ships OTLP/HTTP to
        `self_tracing.endpoint` (a distributor-serving process), so
        cross-process traces carry every role's spans, not just the
        distributor's."""
        cfg = self.cfg.self_tracing
        if not cfg.enabled:
            return
        if self.distributor is not None:
            dist = self.distributor

            def push(tenant: str, traces) -> None:
                dist.push_traces(tenant, traces)
        elif cfg.endpoint:
            from tempo_tpu_torch.backend.httpclient import PooledHTTPClient
            from tempo_tpu_torch.receivers import otlp

            # no retries, short timeout: the exporter's contract is
            # drop-never-amplify, and its re-entrancy guard keeps this
            # POST itself from spawning spans
            client = PooledHTTPClient(cfg.endpoint, timeout_s=5.0, max_retries=0)
            self._self_export_client = client

            def push(tenant: str, traces) -> None:
                client.request(
                    "POST", "/v1/traces",
                    headers={"Content-Type": "application/x-protobuf",
                             "X-Scope-OrgID": tenant},
                    body=otlp.encode_traces_request(traces),
                    ok=(200,),
                )
        else:
            log.warning(
                "self_tracing enabled but target=%s has no distributor and "
                "no self_tracing.endpoint: this role will record nothing",
                self.target,
            )
            return
        self._self_exporter = tracing.SelfTraceExporter(
            push, cfg, governor=self.governor)
        tracing.install_exporter(self._self_exporter, cfg.service_name)

    def _maybe_storage_scanner(self):
        """Storage-health analytics (db/analytics): the periodic scan
        runs on compaction-owning roles — one fleet scanner per
        deployment, beside the one compactor that creates the debt it
        measures. /status/storage on any db-holding role still computes
        on demand."""
        if self.db is None or self.target not in ("all", "compactor"):
            return
        if self.cfg.db.analytics_scan_s <= 0:
            return
        from tempo_tpu_torch.db.analytics import StorageScanner

        self.storage_scanner = StorageScanner(
            self.db, interval_s=self.cfg.db.analytics_scan_s)

    def _maybe_pageheat_exporter(self):
        """Device data-movement export (util/pageheat): refresh the
        per-budget miss-ratio gauges on an interval and, when
        TEMPO_TPU_PAGEHEAT_EXPORT_DIR is set, write the ledger snapshot
        `cli analyse device` replays. Runs wherever block reads happen —
        any role that owns a storage engine."""
        if self.db is None:
            return
        from tempo_tpu_torch.util.pageheat import PageHeatExporter

        self.pageheat_exporter = PageHeatExporter()

    def _maybe_usage_reporter(self):
        cfg = self.cfg
        if cfg.usage_stats is not None and getattr(cfg.usage_stats, "enabled", False):
            from tempo_tpu_torch.usagestats import Reporter

            self.usage_reporter = Reporter(cfg.usage_stats, self.db.backend.raw)
            self.usage_reporter.register_provider(self._storage_scale_stats)

    def _storage_scale_stats(self) -> dict:
        """Feature/scale stats for the anonymous usage snapshot
        (reference: pkg/usagestats Edge/Target entries) — fleet-level
        storage health, NEVER tenant names: block counts, bytes, codec
        mix, compression ratio from the analytics scanner's last pass."""
        scanner = self.storage_scanner
        last = scanner.last_report() if scanner is not None else None
        if last is None:
            return {}
        fleet = last["fleet"]
        out = {
            "storage_blocks": fleet["blocks"],
            "storage_total_bytes": fleet["totalBytes"],
            "storage_total_spans": fleet["totalSpans"],
            "storage_compression_ratio": fleet["compressionRatio"],
            "storage_zonemap_coverage_ratio": fleet["zonemapCoverageRatio"],
            "storage_compaction_debt_row_groups": fleet["compactionDebtRowGroups"],
            "storage_compaction_debt_payoff": fleet["compactionDebtPayoff"],
        }
        for codec, pages in fleet["codecPages"].items():
            out[f"storage_codec_pages_{codec}"] = pages
        return out

    # -- tenant resolution ----------------------------------------------
    def resolve_tenant(self, org_id: str | None) -> str:
        """Reference: multitenancy via X-Scope-OrgID (app auth middleware).

        The reserved dogfood tenant (`_self_`) is addressable even
        without multitenancy — self-traces land there regardless, and an
        operator must be able to query them from a single-tenant
        deployment (X-Scope-OrgID: _self_)."""
        if org_id == tracing.SELF_TENANT:
            return tracing.SELF_TENANT
        if not self.cfg.multitenancy_enabled:
            return DEFAULT_TENANT
        if not org_id:
            raise PermissionError("no org id (X-Scope-OrgID) provided")
        return org_id

    # -- API surface -----------------------------------------------------
    def _require(self, member, what: str):
        if member is None:
            raise RoleUnavailable(f"this process (target={self.target}) does not serve {what}")
        return member

    def push_traces(self, traces, org_id=None):
        self._require(self.distributor, "ingest").push_traces(
            self.resolve_tenant(org_id), traces
        )

    def push_spans(self, batch, org_id=None):
        """Columnar ingest entry: a receiver-decoded SpanBatch straight
        into the distributor fan-out, no object traces in between."""
        self._require(self.distributor, "ingest").push_batch(
            self.resolve_tenant(org_id), batch
        )

    def can_push_spans(self) -> bool:
        """True when the columnar ingest fast path may be used: a
        forwarder tee needs object-form traces, so its presence forces
        the object path."""
        return (self.distributor is not None
                and self.distributor.forwarder_manager is None)

    def find_trace(self, trace_id: bytes, org_id=None):
        return self._require(self.frontend, "queries").find_trace_by_id(
            self.resolve_tenant(org_id), trace_id
        )

    def search(self, req: SearchRequest, org_id=None):
        return self._require(self.frontend, "queries").search(self.resolve_tenant(org_id), req)

    def traceql(self, query: str, org_id=None, **kw):
        return self._require(self.frontend, "queries").traceql(
            self.resolve_tenant(org_id), query, **kw
        )

    def query_range(self, query: str, start_s: int, end_s: int, step_s: int,
                    org_id=None, max_series: int = 64, exemplars: int = 0) -> dict:
        """TraceQL metrics (`{...} | rate() ...`) as a Prometheus matrix."""
        return self._require(self.frontend, "queries").query_range(
            self.resolve_tenant(org_id), query, start_s, end_s, step_s,
            max_series=max_series, exemplars=exemplars,
        )

    def graph_dependencies(self, q: str = "", start_s: int = 0, end_s: int = 0,
                           org_id=None) -> dict:
        """Stored-block service-dependency graph over a TraceQL-selected
        root set (the live generator's edges, but over months of blocks)."""
        return self._require(self.frontend, "queries").graph_dependencies(
            self.resolve_tenant(org_id), q, start_s, end_s
        )

    def graph_critical_path(self, q: str = "", start_s: int = 0, end_s: int = 0,
                            by: str = "service", org_id=None) -> dict:
        """Per-trace longest self-time paths, attributed by service or
        span name — "where does p99 actually go" over any spanset."""
        return self._require(self.frontend, "queries").graph_critical_path(
            self.resolve_tenant(org_id), q, start_s, end_s, by=by
        )

    def graph_walks(self, q: str = "", start_s: int = 0, end_s: int = 0,
                    org_id=None, **kw) -> dict:
        """Seeded temporal random walks over the aggregated service graph."""
        return self._require(self.frontend, "queries").graph_walks(
            self.resolve_tenant(org_id), q, start_s, end_s, **kw
        )

    def search_tags(self, org_id=None) -> list[str]:
        """Reference: /api/search/tags is proxied by the frontend straight
        to queriers (no sharding middleware)."""
        return self._require(self.querier, "tag queries").search_tags(
            self.resolve_tenant(org_id)
        )

    def search_tag_values(self, tag: str, org_id=None) -> list[str]:
        return self._require(self.querier, "tag queries").search_tag_values(
            self.resolve_tenant(org_id), tag
        )

    # -- standing queries -------------------------------------------------
    def _standing(self):
        return self._require(self.standing, "standing queries")

    def standing_register(self, body: dict, org_id=None) -> dict:
        """POST /api/metrics/standing: register a query_range query for
        incremental evaluation (validated by the exact metrics grammar/
        planner; caps via standing config + per-tenant Limits)."""
        tenant = self.resolve_tenant(org_id)
        q = self._standing().register(
            tenant,
            query=str(body.get("q") or body.get("query") or ""),
            step_s=int(body.get("step", 0)),
            window_s=int(body.get("window", 0)),
            alert=body.get("alert"),
            max_series=int(body.get("maxSeries", 64)),
            deviation=body.get("deviation"),
        )
        return q.to_doc()

    def standing_list(self, org_id=None) -> list[dict]:
        return self._standing().list(self.resolve_tenant(org_id))

    def standing_read(self, qid: str, org_id=None, start_s: int = 0,
                      end_s: int = 0, step_s: int = 0) -> dict:
        return self._standing().read(self.resolve_tenant(org_id), qid,
                                     start_s=start_s, end_s=end_s,
                                     step_s=step_s)

    def standing_state(self, qid: str, org_id=None) -> dict:
        return self._standing().state(self.resolve_tenant(org_id), qid)

    def standing_delete(self, qid: str, org_id=None) -> None:
        self._standing().delete(self.resolve_tenant(org_id), qid)

    # -- auto-RCA incidents -----------------------------------------------
    def rca_list(self, org_id=None) -> list[dict]:
        """GET /api/rca: newest-first incident summaries — the tenant's
        own plus global (process-level SLO) incidents."""
        return self._require(self.rca, "rca incidents").list(
            self.resolve_tenant(org_id))

    def rca_get(self, incident_id: str, org_id=None) -> dict:
        """GET /api/rca/{incidentID}: the full incident record (finding
        + evidence bundle)."""
        return self._require(self.rca, "rca incidents").get(
            incident_id, self.resolve_tenant(org_id))

    # -- lifecycle -------------------------------------------------------
    def start_loops(self):
        for ing in self.ingesters.values():
            ing.start_loop()
        if self.db is not None:
            self.db.enable_polling()
        if self.compactor is not None:
            self.compactor.start()
        if self.remote_write_storage is not None and self.generator is not None:
            self.remote_write_storage.start_loop(self.generator)
        if self.usage_reporter is not None:
            self.usage_reporter.start_loop()
        if self.storage_scanner is not None:
            self.storage_scanner.start()
        if self.pageheat_exporter is not None:
            self.pageheat_exporter.start()
        if self.vulture is not None:
            self.vulture.start()
        if self.slo_engine is not None:
            self.slo_engine.start()
        if self.rca is not None:
            self.rca.start()

    def sweep_all(self, immediate: bool = False):
        """Deterministic maintenance for tests/drives."""
        for ing in self.ingesters.values():
            ing.sweep(immediate=immediate)

    def service_states(self) -> dict:
        states = {"target": self.target}
        for name in ("distributor", "querier", "frontend", "compactor",
                     "generator", "vulture", "slo_engine", "standing",
                     "rca"):
            if getattr(self, name) is not None:
                states[name] = "Running"
        for iid in self.ingesters:
            states[iid] = "Running"
        return states

    def shutdown(self):
        # detach the dogfood exporter FIRST: a background sweep/flush
        # must not export into a distributor that is tearing down (and
        # tests build many apps per process — only OUR exporter is
        # removed, never a newer app's)
        if self._self_exporter is not None:
            tracing.uninstall_exporter(self._self_exporter)
            self._self_exporter = None
        if self._self_export_client is not None:
            self._self_export_client.close()
            self._self_export_client = None
        # the RCA worker goes down FIRST: its evidence collection runs
        # queries against the app being dismantled
        if self.rca is not None:
            self.rca.stop()
        # the prober and SLO engine go down BEFORE the rings/KVs: a
        # check racing the half-dismantled app would record phantom
        # data-loss errors into the very counters alerting watches
        if self.vulture is not None:
            self.vulture.stop()
        if self.slo_engine is not None:
            self.slo_engine.stop()
        for stop in self._heartbeat_stops:
            stop.set()
        for ring, iid in self._registered:
            try:
                ring.unregister(iid)
            except Exception:
                log.exception("ring unregister failed for %s", iid)
        for kv in self._net_kvs:  # after unregister, which needs the KV
            kv.close()
        if self.remote_worker is not None:
            self.remote_worker.stop()
        for ing in self.ingesters.values():
            ing.stop(flush=True)
        if self.standing is not None:
            # after the ingester drain: the final cuts' folds land first,
            # then registrations + state snapshot to the WAL dir
            self.standing.stop()
        if self.workers is not None:
            self.workers.stop()
        elif self.broker is not None:
            self.broker.stop()
        if self.compactor is not None:
            self.compactor.stop()
        if self.remote_write_storage is not None:
            self.remote_write_storage.stop()
        if self.forwarder_manager is not None:
            self.forwarder_manager.stop()
        if self.usage_reporter is not None:
            self.usage_reporter.stop()
        if self.storage_scanner is not None:
            self.storage_scanner.stop()
        if self.pageheat_exporter is not None:
            self.pageheat_exporter.stop()
        if self.db is not None:
            self.db.shutdown()
