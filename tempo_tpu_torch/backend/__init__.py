"""Storage backends: the raw byte-object store contract, the typed block
layer over it, and the filesystem backend. Port of the parts of
tempo_tpu/backend that the block lifecycle uses; the cloud backends,
fault injection and the tenant index arrive with later slices."""

from tempo_tpu_torch.backend.base import (  # noqa: F401
    BlockMeta,
    NotFound,
    RawBackend,
    TypedBackend,
    bloom_name,
)
from tempo_tpu_torch.backend.local import LocalBackend  # noqa: F401
