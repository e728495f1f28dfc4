"""Port of tempo_tpu/backend/local.py, copied as is (host code).

Filesystem backend.

Reference: tempodb/backend/local/local.go. Doubles as the ingester's
completed-but-unflushed block store (reference reuses the local backend
the same way, tempodb/wal/wal.go:69-84). Writes are atomic
(tmp file + rename) so a crash never leaves a half-written meta; data
appends go straight to the target file because a block without meta.json
is invisible to readers (meta is always written last, matching the
reference's write ordering in tempodb.Writer.WriteBlock).
"""

from __future__ import annotations

import os
import shutil
import tempfile

from tempo_tpu_torch.backend.base import NotFound, RawBackend


class LocalBackend(RawBackend):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, keypath: tuple) -> str:
        return os.path.join(self.root, *keypath)

    def _path(self, name: str, keypath: tuple) -> str:
        return os.path.join(self._dir(keypath), name)

    def write(self, name: str, keypath: tuple, data: bytes) -> None:
        d = self._dir(keypath)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{name}.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, self._path(name, keypath))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def append(self, name: str, keypath: tuple, data: bytes) -> None:
        d = self._dir(keypath)
        os.makedirs(d, exist_ok=True)
        with open(self._path(name, keypath), "ab") as f:
            f.write(data)

    def read(self, name: str, keypath: tuple) -> bytes:
        try:
            with open(self._path(name, keypath), "rb") as f:
                return f.read()
        except FileNotFoundError as e:
            raise NotFound(f"{keypath}/{name}") from e

    def read_range(self, name: str, keypath: tuple, offset: int, length: int) -> bytes:
        try:
            with open(self._path(name, keypath), "rb") as f:
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError as e:
            raise NotFound(f"{keypath}/{name}") from e

    def list(self, keypath: tuple) -> list[str]:
        d = self._dir(keypath)
        try:
            return sorted(
                e for e in os.listdir(d)
                if os.path.isdir(os.path.join(d, e))
            )
        except FileNotFoundError:
            return []

    def list_objects(self, keypath: tuple) -> list[str]:
        d = self._dir(keypath)
        try:
            return sorted(
                e for e in os.listdir(d)
                if os.path.isfile(os.path.join(d, e)) and not e.startswith(".")
            )
        except FileNotFoundError:
            return []

    def delete(self, name: str, keypath: tuple) -> None:
        try:
            os.unlink(self._path(name, keypath))
        except FileNotFoundError as e:
            raise NotFound(f"{keypath}/{name}") from e
        # prune empty block dir
        d = self._dir(keypath)
        try:
            if keypath and not os.listdir(d):
                shutil.rmtree(d, ignore_errors=True)
        except FileNotFoundError:
            pass
