"""Config tree: YAML + env expansion + validation warnings.

Reference: cmd/tempo/app/config.go — one Config struct embedding every
module's config (config.go:29-51), populated defaults → YAML
(`-config.file`, with `${VAR}` envsubst expansion done by
cmd/tempo/main.go loadConfig) → flags; `CheckConfig` emits structured
warnings for footguns (config.go:125-170). YAML keys here mirror the
reference's section names (server, distributor, ingester, storage,
compactor, querier, query_frontend, metrics_generator, overrides,
usage_report) so a Tempo operator's mental model carries over.

Port of tempo_tpu/config.py: the same YAML gives the same dataclasses,
with the reference's defaults and the reference's check_config
warnings.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from dataclasses import dataclass, field

import yaml

from tempo_tpu_torch.app import AppConfig
from tempo_tpu_torch.compiled.cache import CompiledConfig
from tempo_tpu_torch.config_sections import DeviceTierConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.modules.forwarder import ForwarderConfig
from tempo_tpu_torch.modules.frontend import FrontendConfig
from tempo_tpu_torch.modules.generator.storage import RemoteWriteConfig
from tempo_tpu_torch.modules.ingester import IngesterConfig
from tempo_tpu_torch.modules.overrides import Limits
from tempo_tpu_torch.rca import RCAConfig
from tempo_tpu_torch.standing import StandingConfig
from tempo_tpu_torch.usagestats import UsageStatsConfig
from tempo_tpu_torch.util import slo as slo_mod
from tempo_tpu_torch.util.resource import ResourceConfig
from tempo_tpu_torch.util.tracing import SelfTracingConfig
from tempo_tpu_torch.vulture import VultureConfig

log = logging.getLogger(__name__)

_ENV_RE = re.compile(r"\$\{(\w+)(?::([^}]*))?\}")


@dataclass
class KafkaReceiverConfig:
    """Kafka ingest (reference: the shim's kafka receiver factory,
    encoding=otlp_proto); empty brokers disables."""

    brokers: list = field(default_factory=list)
    topic: str = "otlp_spans"
    poll_interval_s: float = 0.25
    # consumer group id; empty = single-consumer offset tracking
    group_id: str = ""


@dataclass
class ServerConfig:
    http_listen_address: str = "127.0.0.1"
    http_listen_port: int = 3200
    # OTLP/Jaeger/OpenCensus gRPC ingest (reference: receiver shim port
    # 4317, the default protocol of OTel SDKs/collectors); 0 disables
    grpc_listen_port: int = 0
    # Jaeger agent-mode UDP ports (reference shim hosts thrift_compact
    # 6831 + thrift_binary 6832); 0 disables both here — enable
    # explicitly like the gRPC listener
    jaeger_agent_compact_port: int = 0
    jaeger_agent_binary_port: int = 0
    kafka: KafkaReceiverConfig = field(default_factory=KafkaReceiverConfig)
    log_level: str = "info"


@dataclass
class Config:
    """Top-level process config (reference: app.Config)."""

    target: str = "all"
    server: ServerConfig = field(default_factory=ServerConfig)
    app: AppConfig = field(default_factory=AppConfig)


def expand_env(text: str, env: dict | None = None) -> str:
    """${VAR} / ${VAR:default} substitution (reference: main.go envsubst
    via drone/envsubst)."""
    env = os.environ if env is None else env

    def sub(m: re.Match) -> str:
        return env.get(m.group(1), m.group(2) if m.group(2) is not None else "")

    return _ENV_RE.sub(sub, text)


class ConfigError(ValueError):
    pass


def _from_dict(cls, doc: dict, path: str = ""):
    """Populate dataclass `cls` from a plain dict, strictly: unknown
    keys are errors (the reference's strict-YAML option, on by default
    here — silent typos in storage config are how data gets lost)."""
    if doc is None:
        return cls()
    if not isinstance(doc, dict):
        raise ConfigError(f"{path or cls.__name__}: expected a mapping, got {type(doc).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in doc.items():
        f = fields.get(key)
        if f is None:
            raise ConfigError(
                f"{path + '.' if path else ''}{key}: unknown config key for {cls.__name__}"
            )
        sub_path = f"{path + '.' if path else ''}{key}"
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.default_factory, type) and dataclasses.is_dataclass(f.default_factory)
        ):
            target = f.default_factory if isinstance(f.default_factory, type) else f.type
            kwargs[key] = _from_dict(target, value, sub_path)
        elif isinstance(value, dict) and f.default_factory is not dataclasses.MISSING:
            probe = f.default_factory()
            if dataclasses.is_dataclass(probe):
                kwargs[key] = _from_dict(type(probe), value, sub_path)
            else:
                kwargs[key] = value
        else:
            kwargs[key] = tuple(value) if isinstance(value, list) and _wants_tuple(f) else value
    return cls(**kwargs)


def _wants_tuple(f) -> bool:
    if f.default is not dataclasses.MISSING and isinstance(f.default, tuple):
        return True
    if f.default_factory is not dataclasses.MISSING:
        try:
            return isinstance(f.default_factory(), tuple)
        except Exception:
            return False
    return False


def parse_config(text: str, env: dict | None = None) -> Config:
    doc = yaml.safe_load(expand_env(text, env)) or {}
    if not isinstance(doc, dict):
        raise ConfigError("config root must be a mapping")

    cfg = Config()
    cfg.target = doc.pop("target", cfg.target)
    cfg.server = _from_dict(ServerConfig, doc.pop("server", None), "server")

    app_doc: dict = {}
    # reference section names -> AppConfig fields
    app_doc["multitenancy_enabled"] = doc.pop("multitenancy_enabled", False)
    storage = doc.pop("storage", {}) or {}
    trace = storage.pop("trace", {}) or {}
    if storage:
        raise ConfigError(f"storage.{next(iter(storage))}: unknown config key")
    app = AppConfig()
    app.multitenancy_enabled = bool(app_doc["multitenancy_enabled"])
    app.db = _from_dict(DBConfig, trace, "storage.trace")
    app.ingester = _from_dict(IngesterConfig, doc.pop("ingester", None), "ingester")
    app.frontend = _from_dict(FrontendConfig, doc.pop("query_frontend", None), "query_frontend")

    overrides_doc = doc.pop("overrides", {}) or {}
    app.overrides_path = overrides_doc.pop("per_tenant_override_config", None)
    app.limits = _from_dict(Limits, overrides_doc.pop("defaults", None), "overrides.defaults")
    if overrides_doc:
        raise ConfigError(f"overrides.{next(iter(overrides_doc))}: unknown config key")

    dist = doc.pop("distributor", {}) or {}
    fwd_list = dist.pop("forwarders", []) or []
    app.forwarders = [
        _from_dict(ForwarderConfig, f, f"distributor.forwarders[{i}]")
        for i, f in enumerate(fwd_list)
    ]
    if dist:
        raise ConfigError(f"distributor.{next(iter(dist))}: unknown config key")

    gen = doc.pop("metrics_generator", {}) or {}
    app.generator_enabled = bool(gen.pop("enabled", True))
    rw = gen.pop("remote_write", None)
    if rw:
        app.remote_write = _from_dict(
            RemoteWriteConfig, rw, "metrics_generator.remote_write"
        )
    if gen:
        raise ConfigError(f"metrics_generator.{next(iter(gen))}: unknown config key")

    app.usage_stats = _from_dict(UsageStatsConfig, doc.pop("usage_report", None), "usage_report")
    # overload control plane budgets (util/resource.ResourceGovernor)
    app.resource = _from_dict(ResourceConfig, doc.pop("resource", None), "resource")
    # self-observability: the engine traces itself into `_self_`
    app.self_tracing = _from_dict(
        SelfTracingConfig, doc.pop("self_tracing", None), "self_tracing")
    # continuous-verification prober (in-process on target=all, or the
    # whole process when target=vulture)
    app.vulture = _from_dict(VultureConfig, doc.pop("vulture", None), "vulture")
    # standing-query engine (registration caps, snapshot cadence, tail)
    app.standing = _from_dict(StandingConfig, doc.pop("standing", None), "standing")
    # device-resident hot tier (budget_mb=0 disables)
    app.device_tier = _from_dict(
        DeviceTierConfig, doc.pop("device_tier", None), "device_tier")
    # compiled-query tier (shape-keyed fused programs; enabled=false or
    # TEMPO_TPU_COMPILED=0 routes every query to the interpreter)
    app.compiled = _from_dict(
        CompiledConfig, doc.pop("compiled", None), "compiled")
    # auto-RCA incident engine (triggered by SLO burns / standing
    # deviations; check_config warns when its triggers are disabled)
    app.rca = _from_dict(RCAConfig, doc.pop("rca", None), "rca")
    # burn-rate SLO engine; objectives is a LIST of dataclasses, handled
    # like distributor.forwarders
    slo_doc = doc.pop("slo", {}) or {}
    if not isinstance(slo_doc, dict):
        raise ConfigError("slo: expected a mapping")
    obj_list = slo_doc.pop("objectives", []) or []
    app.slo = _from_dict(slo_mod.SLOConfig, slo_doc, "slo")
    app.slo.objectives = [
        _from_dict(slo_mod.SLOObjective, o, f"slo.objectives[{i}]")
        for i, o in enumerate(obj_list)
    ]

    for key in ("replication_factor", "n_ingesters", "query_workers"):
        if key in doc:
            setattr(app, key, int(doc.pop(key)))
    # microservices-mode identity + discovery (reference: memberlist join
    # config + per-role flags)
    for key in ("instance_id", "ring_kv_path", "ring_kv_url", "advertise_addr",
                "frontend_address"):
        if key in doc:
            setattr(app, key, str(doc.pop(key)))
    if "ring_heartbeat_timeout_s" in doc:
        app.ring_heartbeat_timeout_s = float(doc.pop("ring_heartbeat_timeout_s"))

    if doc:
        raise ConfigError(f"{next(iter(doc))}: unknown top-level config key")
    cfg.app = app
    return cfg


def load_config(path: str, env: dict | None = None) -> Config:
    with open(path) as f:
        return parse_config(f.read(), env)


def check_config(cfg: Config) -> list[str]:
    """Footgun warnings (reference: CheckConfig config.go:125-170) —
    never fatal, always loud."""
    warnings = []
    app = cfg.app
    if app.replication_factor > app.n_ingesters:
        warnings.append(
            f"replication_factor ({app.replication_factor}) > n_ingesters "
            f"({app.n_ingesters}): every push will fail quorum"
        )
    if app.db.backend in ("s3", "gcs", "azure") and app.db.cache == "none":
        warnings.append(
            "cloud backend without a cache: every bloom test pays an object-store round trip"
        )
    if app.db.block.bloom_fp > 0.05:
        warnings.append(
            f"bloom_fp {app.db.block.bloom_fp} is high; trace-by-ID will touch many blocks"
        )
    if app.limits.block_retention_s and (
        app.limits.block_retention_s < app.db.compaction.window_s
    ):
        warnings.append(
            "per-tenant retention is shorter than the compaction window: "
            "blocks may be deleted before ever being compacted"
        )
    if app.ingester.complete_block_timeout_s < app.db.blocklist_poll_s:
        warnings.append(
            "ingester.complete_block_timeout_s < storage.trace.blocklist_poll_s: "
            "queriers may miss traces between ingester handoff and blocklist poll"
        )
    if app.remote_write is not None and app.remote_write.endpoint and not app.generator_enabled:
        warnings.append("metrics_generator.remote_write set but the generator is disabled")
    if app.resource.hard_watermark <= app.resource.soft_watermark:
        warnings.append(
            f"resource.hard_watermark ({app.resource.hard_watermark}) <= soft_watermark "
            f"({app.resource.soft_watermark}): pushes will be refused before any "
            "early-flush pressure response can run"
        )
    if app.ingester.max_block_bytes > app.resource.wal_head_bytes > 0:
        warnings.append(
            "ingester.max_block_bytes exceeds resource.wal_head_bytes: a single head "
            "block can push the process to critical pressure before it is cut"
        )
    if app.self_tracing.enabled and app.self_tracing.max_spans_per_s > 50_000:
        warnings.append(
            f"self_tracing.max_spans_per_s ({app.self_tracing.max_spans_per_s:g}) "
            "is a large share of typical ingest: the observer should stay a "
            "rounding error next to user traffic"
        )
    if app.self_tracing.enabled and not (0.0 <= app.self_tracing.sample_ratio <= 1.0):
        warnings.append(
            f"self_tracing.sample_ratio ({app.self_tracing.sample_ratio}) is "
            "outside [0, 1]; values clamp to never/always"
        )
    if 0 < app.db.analytics_scan_s < app.db.blocklist_poll_s:
        warnings.append(
            "storage.trace.analytics_scan_s is shorter than blocklist_poll_s: "
            "scans between polls re-walk an unchanged blocklist for nothing"
        )
    resident_cap = app.frontend.target_bytes_per_job * max(1, app.frontend.query_shards)
    if 0 < app.resource.inflight_query_bytes < 2 * resident_cap:
        warnings.append(
            "resource.inflight_query_bytes is below twice the per-query resident "
            f"ceiling ({resident_cap} bytes = query_shards x target_bytes_per_job): "
            "two concurrent broad queries cannot both be admitted"
        )
    # -- continuous-verification plane ----------------------------------
    vulture_armed = app.vulture.enabled or cfg.target == "vulture"
    if vulture_armed:
        # the aged tier exists to pin POST-COMPACTION blocks: a probe
        # must be old enough that its block was cut from the WAL head
        # AND swept through at least one compaction window before the
        # aged check picks it — otherwise "aged" silently re-tests the
        # recent tier and compaction bugs go unwatched
        compaction_cycle_s = (app.ingester.max_block_duration_s
                              + app.db.compaction.window_s)
        if app.vulture.aged_min_age_s < compaction_cycle_s:
            warnings.append(
                f"vulture.aged_min_age_s ({app.vulture.aged_min_age_s}s) is "
                "shorter than one block-cut + compaction cycle "
                f"(ingester.max_block_duration_s + compaction window = "
                f"{compaction_cycle_s:g}s): aged-tier probes will not "
                "outlive a compaction cycle and cannot pin that tier"
            )
        if app.vulture.retention_s <= app.vulture.aged_min_age_s:
            warnings.append(
                f"vulture.retention_s ({app.vulture.retention_s}s) <= "
                f"aged_min_age_s ({app.vulture.aged_min_age_s}s): the aged "
                "tier window is empty and aged checks will never run"
            )
        if app.vulture.write_backoff_s > app.vulture.recent_min_age_s:
            warnings.append(
                f"vulture.write_backoff_s ({app.vulture.write_backoff_s}s) "
                f"exceeds recent_min_age_s ({app.vulture.recent_min_age_s}s): "
                "some cycles have no fresh-tier probe to check"
            )
    # -- standing queries + step-partial downsampling tier ---------------
    if app.standing.enabled and app.multitenancy_enabled \
            and app.standing.max_queries_per_tenant <= 0:
        warnings.append(
            "standing.max_queries_per_tenant is unset in a multitenant "
            "cluster: any tenant can register unbounded standing queries, "
            "each evaluated on every ingest cut (set the cap, or per-tenant "
            "overrides.max_standing_queries)"
        )
    from tempo_tpu_torch.standing import rules as _sp_rules

    for rule in _sp_rules.parse_rules(
            tuple(tuple(r) for r in (app.db.block.step_partial_rules or ()))):
        if rule.step_s > app.ingester.max_block_duration_s:
            warnings.append(
                f"step-partial rule {rule.name!r} step ({rule.step_s}s) is "
                "coarser than ingester.max_block_duration_s "
                f"({app.ingester.max_block_duration_s:g}s): a flushed block "
                "spans less than one step, so its partial degenerates to a "
                "single bin and downsampled reads gain nothing over spans"
            )
        try:
            from tempo_tpu_torch.metrics_engine.plan import MAX_SLOTS

            t = _sp_rules.rule_template(rule)
            day_bins = max(1, 86400 // rule.step_s)
            if rule.max_series * day_bins * t.n_buckets > MAX_SLOTS:
                warnings.append(
                    f"step-partial rule {rule.name!r} series ceiling "
                    f"({rule.max_series} series x {day_bins} bins/day x "
                    f"{t.n_buckets} buckets) exceeds plan.MAX_SLOTS "
                    f"({MAX_SLOTS}): day-scale reads of this rule cannot "
                    "fit one slot space — raise the step or lower the "
                    "ceiling"
                )
        except Exception:  # noqa: BLE001 — an uncompilable rule already
            pass  # warned at parse_rules time (dropped loudly)
    # -- device-resident hot tier -----------------------------------------
    if app.device_tier.budget_mb > 0:
        from tempo_tpu_torch.encoding.vtpu.colcache import hbm_headroom_bytes

        budget = app.device_tier.budget_mb << 20
        headroom = hbm_headroom_bytes()
        if 0 < headroom < budget:
            warnings.append(
                f"device_tier.budget_mb ({app.device_tier.budget_mb}) exceeds "
                f"detected accelerator memory ({headroom} bytes): admissions "
                "will OOM the device before the tier's own eviction runs — "
                "size the tier from the what-if knee, not the whole HBM"
            )
        if not app.device_tier.respect_governor:
            warnings.append(
                "device_tier.respect_governor=false with a non-zero budget: "
                "the hot tier will NOT shed under memory pressure, breaking "
                "the shed order (device tier -> host tier -> ingest refusal) "
                "the overload plane depends on"
            )
        host_cache = int(os.environ.get("TEMPO_TPU_COLCACHE_MB", "256")) << 20
        if 0 < host_cache < budget:
            warnings.append(
                f"host column cache ({host_cache >> 20} MB, "
                "TEMPO_TPU_COLCACHE_MB) is smaller than device_tier.budget_mb "
                f"({app.device_tier.budget_mb} MB): an inverted cache "
                "hierarchy — every device admission rebuilds its payload "
                "through a host tier too small to hold it"
            )
    # -- device-native ingest plane ---------------------------------------
    if os.environ.get("TEMPO_TPU_DEVICE_ENCODE", "").lower() in (
            "1", "true", "yes", "force") and app.device_tier.budget_mb <= 0:
        warnings.append(
            "TEMPO_TPU_DEVICE_ENCODE is forced on while device_tier.budget_mb "
            "is 0: flush pages encode on device but the just-cut tail cannot "
            "stay resident, so every standing fold and live-tail search "
            "re-ships the columns the encoder just had in HBM — give the "
            "tier a budget (with an ingest_tail share) or drop the override"
        )
    tail_mb = app.device_tier.ingest_tail_budget_mb
    if tail_mb > 0:
        if tail_mb > app.device_tier.budget_mb:
            warnings.append(
                f"device_tier.ingest_tail_budget_mb ({tail_mb}) exceeds "
                f"device_tier.budget_mb ({app.device_tier.budget_mb}): the "
                "tail share is carved OUT of the tier budget, never added "
                "to it — an inverted hierarchy that evicts every hot page "
                "to park tails which then shed first anyway"
            )
        # parked tail per cut ~ 44 bytes/span of the cut batch; an
        # immediate (pressure) cut can cut the whole live-trace pool at
        # once, so a tail budget under ~1/8 of that pool churns: each
        # cut evicts the previous cut before any query sees it resident
        live_bytes = app.resource.live_trace_bytes
        if 0 < live_bytes and (tail_mb << 20) < live_bytes // 8:
            warnings.append(
                f"device_tier.ingest_tail_budget_mb ({tail_mb}) cannot hold "
                "one maximum cut (resource.live_trace_bytes "
                f"{live_bytes >> 20} MB cut at once parks ~"
                f"{live_bytes >> 23} MB of columns): tails evict each other "
                "before standing folds or live-tail search hit them — size "
                "the share to at least live_trace_bytes/8"
            )
    # -- compiled-query tier ----------------------------------------------
    if app.compiled.enabled and app.multitenancy_enabled \
            and app.compiled.max_shapes <= 0:
        warnings.append(
            "compiled.max_shapes is unset in a multitenant cluster: query "
            "text is tenant-controlled, so distinct literal-stripped shapes "
            "— and the jitted programs behind them — can grow without bound "
            "(set the cap; the LRU keeps hot dashboards compiled)"
        )
    if app.compiled.enabled and app.device_tier.budget_mb > 0:
        from tempo_tpu_torch.encoding.vtpu.colcache import hbm_headroom_bytes as _hbm

        headroom = _hbm()
        if 0 < headroom < (app.device_tier.budget_mb << 20):
            warnings.append(
                "compiled tier enabled while device_tier.budget_mb exceeds "
                "detected accelerator memory: the tier's stacked page sets "
                "and cached executables compete for HBM the page budget "
                "already oversubscribes — shrink the budget below the "
                "headroom before enabling compiled execution"
            )
    # -- result cache ------------------------------------------------------
    if app.db.result_cache.enabled and app.db.cache == "none":
        warnings.append(
            "storage.trace.result_cache is enabled with cache: none — the "
            "cache is in-process-LRU only, so replicas never share partials "
            "and every restart starts cold (point cache: at the memcached/"
            "redis pool the shard partials should ride)"
        )
    if app.db.result_cache.enabled and app.db.result_cache.negative and \
            os.environ.get("TEMPO_TPU_ZONEMAPS", "").lower() in (
                "0", "false", "no"):
        warnings.append(
            "result_cache.negative is on while TEMPO_TPU_ZONEMAPS disables "
            "zone maps: provable-emptiness comes from zone/window pruning, "
            "so no veto can ever be cached (stats-less legacy blocks have "
            "the same blind spot) — the negative tier silently never fires"
        )
    if app.slo.enabled:
        for obj in (app.slo.objectives or slo_mod.default_objectives()):
            if obj.sli not in slo_mod.SLI_SOURCES:
                warnings.append(
                    f"slo objective {obj.name!r} references unknown SLI "
                    f"source {obj.sli!r} (have "
                    f"{sorted(slo_mod.SLI_SOURCES)}): it will never leave 100%"
                )
            elif obj.sli in ("vulture", "freshness") and not vulture_armed:
                warnings.append(
                    f"slo objective {obj.name!r} consumes the {obj.sli} SLI "
                    "but no vulture runs in this process "
                    "(vulture.enabled=false): its counters will stay empty"
                )
            if not (0.0 < obj.objective < 1.0):
                warnings.append(
                    f"slo objective {obj.name!r} target {obj.objective} is "
                    "outside (0, 1): burn rates are undefined"
                )
    # -- auto-RCA incident engine -----------------------------------------
    if app.rca.enabled and not app.slo.enabled:
        warnings.append(
            "rca is enabled without slo: the fast-burn trigger never "
            "fires, so incidents only open on standing-query deviations "
            "(enable slo for the full closed loop)"
        )
    if app.rca.enabled and not app.standing.enabled:
        warnings.append(
            "rca is enabled without standing: the deviation trigger never "
            "fires, so anomalies cannot open incidents BEFORE the SLO "
            "burns (enable standing and register queries with a "
            "deviation: section)"
        )
    return warnings
