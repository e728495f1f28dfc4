"""Storage backends: the raw byte-object store contract, the typed block
layer over it, the filesystem and in-memory backends, the tenant index
and the retry taxonomy. Port of tempo_tpu/backend; the cloud backends
(GCS/S3/Azure) and fault injection (`FaultInjectingBackend` with
`TEMPO_TPU_FAULTS`) arrive with later slices.
"""

from tempo_tpu_torch.backend.base import (  # noqa: F401
    BlockMeta,
    CompactedBlockMeta,
    NotFound,
    RawBackend,
    TypedBackend,
    bloom_name,
)
from tempo_tpu_torch.backend.local import LocalBackend  # noqa: F401
from tempo_tpu_torch.backend.mock import MockBackend  # noqa: F401


def make_raw_backend(kind: str, options: dict | None = None) -> RawBackend:
    """Backend factory (reference: tempodb.New backend selection,
    tempodb/tempodb.go:133-170; tempo_tpu/backend/__init__.py:25-80).
    The cloud backends are not ported yet and raise."""
    options = options or {}
    if kind == "local":
        return LocalBackend(options.get("path", "blocks"))
    if kind == "mock":
        return MockBackend()
    if kind in ("s3", "gcs", "azure"):
        raise NotImplementedError(
            f"tempo_tpu_torch: the {kind} backend is not ported yet "
            "(have local|mock)")
    raise ValueError(f"unknown backend {kind!r} (have local|mock|s3|gcs|azure)")
