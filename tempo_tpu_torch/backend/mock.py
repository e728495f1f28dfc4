"""Port of tempo_tpu/backend/mock.py, copied as is (host code).

In-memory backend for tests (reference: tempodb/backend/mocks.go:20-150).

Thread-safe. fail_every survives for old tests, but new fault testing
should wrap a plain MockBackend in backend/faults.FaultInjectingBackend
— it subsumes fail_every (FaultPlan(fail_every=N)) and adds seeded
error rates, NotFound flaps, latency spikes, short reads, and bit-flip
corruption, all reproducible from the plan seed.
"""

from __future__ import annotations

import threading

from tempo_tpu_torch.backend.base import NotFound, RawBackend


class MockBackend(RawBackend):
    def __init__(self, fail_every: int = 0):
        self.objects: dict[tuple, bytes] = {}
        self.lock = threading.Lock()
        self.fail_every = fail_every  # every Nth op raises IOError
        self._ops = 0
        self.reads = 0
        self.writes = 0
        self.bytes_read = 0

    def _maybe_fail(self):
        self._ops += 1
        if self.fail_every and self._ops % self.fail_every == 0:
            raise IOError("injected backend failure")

    def write(self, name, keypath, data):
        self._maybe_fail()
        with self.lock:
            self.objects[keypath + (name,)] = bytes(data)
            self.writes += 1

    def append(self, name, keypath, data):
        self._maybe_fail()
        with self.lock:
            key = keypath + (name,)
            self.objects[key] = self.objects.get(key, b"") + bytes(data)
            self.writes += 1

    def read(self, name, keypath):
        self._maybe_fail()
        with self.lock:
            key = keypath + (name,)
            if key not in self.objects:
                raise NotFound(f"{keypath}/{name}")
            self.reads += 1
            data = self.objects[key]
            self.bytes_read += len(data)
            return data

    def read_range(self, name, keypath, offset, length):
        self._maybe_fail()
        with self.lock:
            key = keypath + (name,)
            if key not in self.objects:
                raise NotFound(f"{keypath}/{name}")
            self.reads += 1
            self.bytes_read += length
            return self.objects[key][offset : offset + length]

    def list(self, keypath):
        with self.lock:
            depth = len(keypath)
            out = set()
            for key in self.objects:
                if len(key) > depth + 1 and key[:depth] == keypath:
                    out.add(key[depth])
            return sorted(out)

    def list_objects(self, keypath):
        with self.lock:
            depth = len(keypath)
            return sorted(
                key[-1] for key in self.objects
                if len(key) == depth + 1 and key[:depth] == keypath
            )

    def delete(self, name, keypath):
        with self.lock:
            key = keypath + (name,)
            if key not in self.objects:
                raise NotFound(f"{keypath}/{name}")
            del self.objects[key]
