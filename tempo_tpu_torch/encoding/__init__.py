"""Block encoding registry.

Port of tempo_tpu/encoding/__init__.py. The registry knows `vtpu1`;
the `vrow` row-oriented encoding is a later slice of the port (ROADMAP
Queue 1), and asking for it raises NotImplementedError.

Reference: tempodb/encoding/versioned.go:18-68 — a VersionedEncoding
interface (OpenBlock / CreateBlock / NewCompactor / WAL block ops) keyed
by version string, selected via the block-version config knob so the
data plane swaps without touching the control plane.
"""

from __future__ import annotations

from tempo_tpu_torch.encoding import vtpu
from tempo_tpu_torch.encoding.common import BlockConfig, SearchRequest  # noqa: F401
from tempo_tpu_torch.encoding.vtpu.encoding import Encoding as _VtpuEncoding

DEFAULT_ENCODING = "vtpu1"

_REGISTRY = {
    vtpu.VERSION: _VtpuEncoding(),
}


def from_version(version: str):
    """version string -> encoding impl (reference: versioned.go:54-62)."""
    enc = _REGISTRY.get(version)
    if enc is None:
        if version == "vrow1":
            raise NotImplementedError(
                "tempo_tpu_torch: the vrow encoding is not ported yet "
                "(ROADMAP Queue 1)")
        raise ValueError(f"unknown block encoding {version!r} (have {sorted(_REGISTRY)})")
    return enc


def default_encoding():
    return from_version(DEFAULT_ENCODING)


def all_encodings():
    return list(_REGISTRY.values())
