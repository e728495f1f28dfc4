"""Metrics-generator — span stream -> RED metrics + service graphs.

Reference: modules/generator (instance.go:127-261 processor lifecycle +
pushSpans, processor/spanmetrics, processor/servicegraphs, registry/ —
a TSDB-lite of counters/histograms with staleness + active-series
limits, remote-written to Prometheus).

Array-first: processors consume columnar SpanBatches; aggregation is
vectorized group-by (np.unique over composite key arrays + bincount /
searchsorted histogramming), and service-graph cardinality is tracked
with the HLL/count-min device sketches (BASELINE.json config 3).

Port of tempo_tpu/modules/generator/__init__.py. The generator takes a
torch `device` (the App's; CUDA unless the caller passes "cpu") on
which every tenant's service-graph sketches live. Its series leave by
Prometheus remote write through modules/generator/storage when
`metrics_generator.remote_write` names an endpoint.
"""

from __future__ import annotations

import logging
import threading

from tempo_tpu_torch import device as _device
from tempo_tpu_torch.encoding.vtpu import format as fmt
from tempo_tpu_torch.modules.generator.registry import ManagedRegistry
from tempo_tpu_torch.modules.generator.servicegraphs import ServiceGraphsProcessor
from tempo_tpu_torch.modules.generator.spanmetrics import SpanMetricsProcessor

log = logging.getLogger(__name__)

PROCESSOR_SPAN_METRICS = "span-metrics"
PROCESSOR_SERVICE_GRAPHS = "service-graphs"
DEFAULT_PROCESSORS = (PROCESSOR_SPAN_METRICS, PROCESSOR_SERVICE_GRAPHS)


class TenantGeneratorInstance:
    def __init__(self, tenant: str, overrides, device=None):
        self.tenant = tenant
        self.overrides = overrides
        lim = overrides.for_tenant(tenant)
        self.registry = ManagedRegistry(
            tenant, max_active_series=lim.metrics_generator_max_active_series
        )
        procs = lim.metrics_generator_processors or DEFAULT_PROCESSORS
        self.processors = []
        if PROCESSOR_SPAN_METRICS in procs:
            self.processors.append(SpanMetricsProcessor(self.registry))
        if PROCESSOR_SERVICE_GRAPHS in procs:
            self.processors.append(ServiceGraphsProcessor(self.registry, device=device))

    def push_batch(self, batch) -> None:
        for p in self.processors:
            p.push(batch)


class Generator:
    def __init__(self, overrides, instance_id: str = "generator-0", device=None):
        self.overrides = overrides
        self.instance_id = instance_id
        self.device = _device.resolve(device)
        self.instances: dict[str, TenantGeneratorInstance] = {}
        self.lock = threading.Lock()

    def instance(self, tenant: str) -> TenantGeneratorInstance:
        with self.lock:
            inst = self.instances.get(tenant)
            if inst is None:
                inst = TenantGeneratorInstance(tenant, self.overrides, device=self.device)
                self.instances[tenant] = inst
            return inst

    def push_segment(self, tenant: str, data: bytes) -> None:
        self.instance(tenant).push_batch(fmt.deserialize_batch(data))

    def push_batch(self, tenant: str, batch) -> None:
        self.instance(tenant).push_batch(batch)

    def collect(self, tenant: str) -> list:
        """Samples for remote write / scrape."""
        return self.instance(tenant).registry.collect()

    def prometheus_text(self) -> str:
        with self.lock:
            instances = list(self.instances.values())
        return "".join(i.registry.prometheus_text() for i in instances)
