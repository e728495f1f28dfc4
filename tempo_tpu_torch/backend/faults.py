"""Port of tempo_tpu/backend/faults.py: seeded, deterministic fault
injection at the RawBackend seam, the retryable-vs-terminal error
taxonomy (`retryable_error`) and the per-operation retry loop
(`with_retries`) that TempoDB's block-scoped reads run under.

Every fault decision is a pure function of (plan seed, op kind, per-op
sequence number), so a chaos run replays bit-identically from its seed,
and the same sequence of operations draws the same faults here as in the
reference. `TEMPO_TPU_FAULTS` ("read=0.01,corrupt=0.001,seed=7") arms a
process-wide plan that make_raw_backend applies to every backend it
builds, and the result cache applies its corrupt and short-read rates to
the entries it fetches.

Fault classes (all off by default): per-op transient IOError rates,
NotFound flaps on reads, latency spikes bounded by the propagated
deadline, short reads of read_range, bit flips in returned read bytes,
every Nth op failing, and deny_names (object names whose listed ops
always fail: the crash-simulation knob).

Connection-ish errors retry; NotFound / CorruptPage / DeadlineExceeded /
client errors are terminal.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import defaultdict
from dataclasses import dataclass, field

from tempo_tpu_torch.backend.base import NotFound, RawBackend
from tempo_tpu_torch.util import deadline

_MASK = (1 << 64) - 1

# ops that return data (corruption / short reads / NotFound flaps apply)
_READ_OPS = ("read", "read_range")
OPS = ("read", "read_range", "write", "append", "list", "delete")


def _mix(*parts: int) -> int:
    """splitmix64-style hash of integer parts — THE determinism source:
    one fault decision = _mix(seed, op tag, sequence number, salt)."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (p & _MASK)) * 0xBF58476D1CE4E5B9 & _MASK
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK
    x ^= x >> 31
    return x


def _roll(seed: int, op: str, n: int, salt: int) -> float:
    """Uniform [0, 1) deterministic in (seed, op, n, salt). The op tag is
    crc32, NOT builtin hash(): str hashes are salted per process, which
    would silently break cross-run replay of a schedule."""
    return (_mix(seed, zlib.crc32(op.encode()), n, salt) >> 11) / float(1 << 53)


@dataclass
class FaultPlan:
    """All knobs of one reproducible fault schedule."""

    seed: int = 0
    # per-op transient-IOError rates, e.g. {"read": 0.05, "write": 0.1};
    # "all" applies to every op without its own entry
    error_rates: dict = field(default_factory=dict)
    notfound_rate: float = 0.0  # reads flap NotFound on existing objects
    latency_rate: float = 0.0  # fraction of ops that sleep latency_s
    latency_s: float = 0.01
    short_read_rate: float = 0.0  # read_range returns a strict prefix
    corrupt_rate: float = 0.0  # one bit of returned read bytes flips
    fail_every: int = 0  # every Nth op (any kind) raises IOError
    # object names (substring match) whose listed ops always fail —
    # crash simulation ("meta.json" + ("write",) = die before commit)
    deny_names: tuple = ()
    deny_ops: tuple = ("write", "append")

    def rate(self, op: str) -> float:
        r = self.error_rates.get(op)
        return self.error_rates.get("all", 0.0) if r is None else r

    @staticmethod
    def from_spec(spec: str) -> "FaultPlan":
        """Parse "read=0.05,corrupt=0.001,seed=7,latency=0.1" — short keys
        map onto the dataclass; bare op names set error rates."""
        plan = FaultPlan()
        aliases = {
            "notfound": "notfound_rate", "latency": "latency_rate",
            "latency_s": "latency_s", "short": "short_read_rate",
            "corrupt": "corrupt_rate", "seed": "seed",
            "fail_every": "fail_every",
        }
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key in OPS or key == "all":
                plan.error_rates[key] = float(val)
            elif key in aliases:
                attr = aliases[key]
                cur = getattr(plan, attr)
                setattr(plan, attr, type(cur)(float(val)))
            else:
                raise ValueError(f"unknown fault spec key {key!r}")
        return plan


def env_plan() -> FaultPlan | None:
    """The process-wide plan armed via TEMPO_TPU_FAULTS, or None."""
    spec = os.environ.get("TEMPO_TPU_FAULTS", "").strip()
    return FaultPlan.from_spec(spec) if spec else None


class FaultInjectingBackend(RawBackend):
    """Wrap any RawBackend with a FaultPlan.

    Swap `plan` at runtime to heal or escalate mid-test (the chaos suite
    heals the backend to assert recovery). `injected` counts injected
    faults per class for assertions and postmortems.
    """

    def __init__(self, inner: RawBackend, plan: FaultPlan | None = None):
        self.inner = inner
        self.plan = plan or FaultPlan()
        self._lock = threading.Lock()
        self._counts: dict[str, int] = defaultdict(int)
        self._total_ops = 0
        self.injected: dict[str, int] = defaultdict(int)

    # ------------------------------------------------------------------
    def _next(self, op: str) -> tuple[int, int]:
        with self._lock:
            self._counts[op] += 1
            self._total_ops += 1
            return self._counts[op], self._total_ops

    def _note(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] += 1

    def _before(self, op: str, name: str) -> int:
        """Deadline check + pre-op faults. Returns the op sequence number
        (the corruption/short-read salt for read ops)."""
        deadline.check()
        p = self.plan
        n, total = self._next(op)
        if p.deny_names and op in p.deny_ops and any(d in name for d in p.deny_names):
            self._note("deny")
            raise IOError(f"injected denied {op} of {name!r}")
        if p.fail_every and total % p.fail_every == 0:
            self._note("fail_every")
            raise IOError(f"injected backend failure (every {p.fail_every})")
        if p.latency_rate and _roll(p.seed, op, n, 1) < p.latency_rate:
            self._note("latency")
            time.sleep(deadline.bound_timeout(p.latency_s))
            deadline.check()  # a spike that ate the deadline is terminal
        if p.rate(op) and _roll(p.seed, op, n, 2) < p.rate(op):
            self._note(f"error:{op}")
            raise IOError(f"injected {op} failure #{n} for {name!r}")
        if op in _READ_OPS and p.notfound_rate and _roll(p.seed, op, n, 3) < p.notfound_rate:
            self._note("notfound")
            raise NotFound(f"injected NotFound flap for {name!r}")
        return n

    def _mangle(self, op: str, n: int, data: bytes) -> bytes:
        """Post-read faults: short returns and bit flips, positioned
        deterministically from the op sequence number."""
        p = self.plan
        if not data:
            return data
        if op == "read_range" and p.short_read_rate and _roll(p.seed, op, n, 4) < p.short_read_rate:
            self._note("short_read")
            cut = 1 + _mix(p.seed, n, 5) % max(len(data) - 1, 1)
            data = data[:cut]
        if p.corrupt_rate and _roll(p.seed, op, n, 6) < p.corrupt_rate:
            self._note("corrupt")
            pos = _mix(p.seed, n, 7) % len(data)
            bit = 1 << (_mix(p.seed, n, 8) % 8)
            data = data[:pos] + bytes([data[pos] ^ bit]) + data[pos + 1 :]
        return data

    # ------------------------------------------------------------------
    def write(self, name, keypath, data):
        self._before("write", name)
        return self.inner.write(name, keypath, data)

    def append(self, name, keypath, data):
        self._before("append", name)
        return self.inner.append(name, keypath, data)

    def read(self, name, keypath):
        n = self._before("read", name)
        return self._mangle("read", n, self.inner.read(name, keypath))

    def read_range(self, name, keypath, offset, length):
        n = self._before("read_range", name)
        return self._mangle("read_range", n, self.inner.read_range(name, keypath, offset, length))

    def list(self, keypath):
        self._before("list", "")
        return self.inner.list(keypath)

    def list_objects(self, keypath):
        # rides list's fault budget (not all backends expose it)
        self._before("list", "")
        return self.inner.list_objects(keypath)

    def delete(self, name, keypath):
        self._before("delete", name)
        return self.inner.delete(name, keypath)


def retryable_error(e: Exception) -> bool:
    """The retryable-vs-terminal taxonomy (reference: retry.go retries
    5xx only; the SDKs retry connection resets). Terminal: the request
    can never succeed by repetition — missing object, corrupt data,
    exceeded deadline, or a client mistake.

    Overload-control errors compose with it: ResourceExhausted (a shed
    with a retry hint) is retryable-with-backoff."""
    from tempo_tpu_torch.encoding.vtpu.codec import CorruptPage
    from tempo_tpu_torch.util.resource import ResourceExhausted

    if isinstance(e, (NotFound, CorruptPage, deadline.DeadlineExceeded)):
        return False
    if isinstance(e, ResourceExhausted):
        return True
    if isinstance(e, (ValueError, TypeError, KeyError, PermissionError)):
        return False
    return isinstance(e, (IOError, OSError, ConnectionError, TimeoutError))


def with_retries(fn, attempts: int = 3, backoff_s: float = 0.01):
    """Run fn with bounded retries of RETRYABLE errors (taxonomy above),
    backoff clipped to the propagated deadline.

    This is the per-OPERATION retry layer for block-scoped reads
    (TempoDB.guard_block). It matters because the
    job layers above retry whole multi-block jobs: without per-op
    retries, one transient blip anywhere fails the entire job, and the
    probability of a job-level retry passing every operation cleanly
    decays exponentially with job size — under sustained fault rates a
    query can never converge. Per-op retries make each operation
    individually likely to succeed, which is how the reference behaves
    too (its object-store SDK retries sit beneath every read).

    The reference's optional circuit breaker (`breaker=`, util/circuit)
    arrives with the HTTP client that shares it."""
    last: Exception | None = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if not retryable_error(e) or i == attempts - 1:
                raise
            last = e
            time.sleep(deadline.bound_timeout(backoff_s * (2 ** i)))
            deadline.check()  # out of budget mid-backoff: terminal
    raise last  # pragma: no cover — loop always returns or raises
