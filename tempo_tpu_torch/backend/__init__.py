"""Storage backends: the raw byte-object store contract, the typed block
layer over it, the filesystem and in-memory backends, the tenant index,
the retry taxonomy, seeded fault injection (`FaultInjectingBackend`,
armed by `TEMPO_TPU_FAULTS`) and the caching decorator
(`backend/cache.CachedBackend`). Port of tempo_tpu/backend; the cloud
backends (S3, GCS, Azure) are imported lazily, so the local and mock
path needs none of them.
"""

import logging

from tempo_tpu_torch.backend.base import (  # noqa: F401
    BlockMeta,
    CompactedBlockMeta,
    NotFound,
    RawBackend,
    TypedBackend,
    bloom_name,
)
from tempo_tpu_torch.backend.faults import (  # noqa: F401
    FaultInjectingBackend,
    FaultPlan,
    retryable_error,
)
from tempo_tpu_torch.backend.local import LocalBackend  # noqa: F401
from tempo_tpu_torch.backend.mock import MockBackend  # noqa: F401


def make_raw_backend(kind: str, options: dict | None = None) -> RawBackend:
    """Backend factory (reference: tempodb.New backend selection,
    tempodb/tempodb.go:133-170; tempo_tpu/backend/__init__.py:25-80).
    `options` are the backend's config kwargs (`DBConfig.backend_options`).

    TEMPO_TPU_FAULTS (e.g. "read=0.01,corrupt=0.001,seed=7") wraps the
    result in a FaultInjectingBackend — the operator chaos knob; see
    backend/faults.py."""
    return _maybe_inject_faults(_make_raw_backend(kind, options))


def _maybe_inject_faults(raw: RawBackend) -> RawBackend:
    from tempo_tpu_torch.backend import faults

    plan = faults.env_plan()
    if plan is not None:
        logging.getLogger(__name__).warning(
            "TEMPO_TPU_FAULTS is armed — backend %s runs behind fault injection",
            type(raw).__name__,
        )
        return FaultInjectingBackend(raw, plan)
    return raw


def _make_raw_backend(kind: str, options: dict | None = None) -> RawBackend:
    options = options or {}
    if kind == "local":
        return LocalBackend(options.get("path", "blocks"))
    if kind == "mock":
        return MockBackend()
    if kind == "s3":
        from tempo_tpu_torch.backend.s3 import S3Backend, S3Config

        return S3Backend(S3Config(**options))
    if kind == "gcs":
        from tempo_tpu_torch.backend.gcs import GCSBackend, GCSConfig

        return GCSBackend(GCSConfig(**options))
    if kind == "azure":
        from tempo_tpu_torch.backend.azure import AzureBackend, AzureConfig

        return AzureBackend(AzureConfig(**options))
    raise ValueError(f"unknown backend {kind!r} (have local|mock|s3|gcs|azure)")
