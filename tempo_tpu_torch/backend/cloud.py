"""Port of tempo_tpu/backend/cloud.py, copied as is (host code).

Shared machinery for the cloud object-store backends.

Key layout matches the reference's raw keypath model
(tempodb/backend/raw.go:24-48): objects live at
`<prefix>/<tenant>/<blockID>/<name>`; `list` enumerates immediate child
"directories" via delimiter listings.

Append semantics: the engine only appends to a block's data object
while creating the block, and always writes `meta.json` last (see
tempo_tpu_torch/encoding/vtpu/create.py; reference write ordering in
tempodb.Writer.WriteBlock). Cloud stores have no cheap append, so
appends accumulate in memory per object and are flushed as one PUT when
the same block's meta lands (or on explicit flush_appends()). The
reference does the moral equivalent: S3 buffers parts for multipart
upload, Azure accumulates an uncommitted block list
(tempodb/backend/azure/azure.go manual block-put append).
"""

from __future__ import annotations

import threading

from tempo_tpu_torch.backend.base import RawBackend


def join_key(prefix: str, keypath: tuple, name: str = "") -> str:
    parts = [p for p in (prefix, *keypath) if p]
    if name:
        parts.append(name)
    return "/".join(parts)


class CloudBackendBase(RawBackend):
    """Append buffering + dir-listing contract shared by S3/GCS/Azure."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix.strip("/")
        self._appends: dict[str, bytearray] = {}
        self._appends_lock = threading.Lock()

    # subclasses implement the raw object verbs ------------------------
    def _put_object(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def _get_object(self, key: str, offset: int = -1, length: int = -1) -> bytes:
        raise NotImplementedError

    def _delete_object(self, key: str) -> None:
        raise NotImplementedError

    def _list_prefix(self, prefix: str, delimiter: str) -> tuple[list[str], list[str]]:
        """Returns (common_prefixes, object_keys) under prefix."""
        raise NotImplementedError

    # RawBackend ---------------------------------------------------------
    def write(self, name: str, keypath: tuple, data: bytes) -> None:
        self.flush_appends(keypath)
        self._put_object(join_key(self.prefix, keypath, name), data)

    def append(self, name: str, keypath: tuple, data: bytes) -> None:
        key = join_key(self.prefix, keypath, name)
        with self._appends_lock:
            self._appends.setdefault(key, bytearray()).extend(data)

    def flush_appends(self, keypath: tuple | None = None) -> None:
        """Flush buffered appends as whole-object PUTs. keypath=None
        flushes everything."""
        scope = None if keypath is None else join_key(self.prefix, keypath) + "/"
        with self._appends_lock:
            keys = [k for k in self._appends if scope is None or k.startswith(scope)]
            pending = [(k, bytes(self._appends.pop(k))) for k in keys]
        for key, data in pending:
            self._put_object(key, data)

    def read(self, name: str, keypath: tuple) -> bytes:
        return self._get_object(join_key(self.prefix, keypath, name))

    def read_range(self, name: str, keypath: tuple, offset: int, length: int) -> bytes:
        return self._get_object(join_key(self.prefix, keypath, name), offset, length)

    def list(self, keypath: tuple) -> list[str]:
        prefix = join_key(self.prefix, keypath)
        prefix = prefix + "/" if prefix else ""
        dirs, _ = self._list_prefix(prefix, "/")
        return sorted({d.rstrip("/").rsplit("/", 1)[-1] for d in dirs})

    def list_objects(self, keypath: tuple) -> list[str]:
        prefix = join_key(self.prefix, keypath)
        prefix = prefix + "/" if prefix else ""
        _, keys = self._list_prefix(prefix, "/")
        return sorted(k.rsplit("/", 1)[-1] for k in keys)

    def delete(self, name: str, keypath: tuple) -> None:
        key = join_key(self.prefix, keypath, name)
        with self._appends_lock:
            self._appends.pop(key, None)
        self._delete_object(key)
