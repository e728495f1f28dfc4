"""Block encoding registry.

Port of tempo_tpu/encoding/__init__.py: the registry knows `vtpu1`
(the default) and `vrow1`, the row-oriented legacy encoding.

Reference: tempodb/encoding/versioned.go:18-68 — a VersionedEncoding
interface (OpenBlock / CreateBlock / NewCompactor / WAL block ops) keyed
by version string, selected via the block-version config knob so the
data plane swaps without touching the control plane.
"""

from __future__ import annotations

from tempo_tpu_torch.encoding import vrow, vtpu
from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest  # noqa: F401
from tempo_tpu_torch.encoding.vtpu.encoding import Encoding as _VtpuEncoding

DEFAULT_ENCODING = "vtpu1"

_REGISTRY = {
    vtpu.VERSION: _VtpuEncoding(),
    vrow.VERSION: vrow.Encoding(),
}


def from_version(version: str):
    """version string -> encoding impl (reference: versioned.go:54-62)."""
    enc = _REGISTRY.get(version)
    if enc is None:
        raise ValueError(f"unknown block encoding {version!r} (have {sorted(_REGISTRY)})")
    return enc


def default_encoding():
    return from_version(DEFAULT_ENCODING)


def all_encodings():
    return list(_REGISTRY.values())
