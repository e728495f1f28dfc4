"""Shape-keyed program cache for the compiled-query tier.

Port of tempo_tpu/compiled/cache.py. A "program" in the port is the
launch plan of the fused metrics kernels for one static signature
(compiled/program.py): PyTorch runs eagerly, so there is no jit trace to
hold, but the cache keeps the same entries and counts the same hits,
misses, compiles and evictions, which /api/query-insights returns.

Two levels, both bounded:

  * the SHAPE cache maps a normalized query shape (util/queryshape —
    the same key space the insights log groups records by) to what the
    lowering learned about it: lowerable or not, plus per-shape hit
    accounting. A hit on a known-unlowerable shape short-circuits to
    the interpreter without re-walking the AST.
  * the PROGRAM cache (compiled/program.py) maps a static signature —
    codec mix, column count, pad widths — to ONE fused device
    program. Literals, time bounds and the bin count are runtime
    arguments, so a dashboard refresh with new constants reuses the
    program: nothing is rebuilt.

Both shed under the process governor like the device tier does
(colcache.DeviceTier): at PRESSURE the shape cache drops to a quarter
of its entries and the program cache clears; at CRITICAL both clear.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict

from tempo_tpu_torch.util import metrics

compiled_hits_total = metrics.counter(
    "tempo_tpu_compiled_hits_total",
    "Compiled-tier shape-cache hits: the query's normalized shape was "
    "already lowered (or known unlowerable) — no AST re-walk",
)
compiled_misses_total = metrics.counter(
    "tempo_tpu_compiled_misses_total",
    "Compiled-tier shape-cache misses: first sighting of a normalized "
    "query shape (the lowering walk runs once, then is remembered)",
)
compiled_compiles_total = metrics.counter(
    "tempo_tpu_compiled_compiles_total",
    "Fused-program traces: a (codec mix, pad widths) signature was "
    "jitted for the first time. Steady-state repeated-shape traffic "
    "holds this flat while hits climb — that flatness IS the tier",
)
compiled_evictions_total = metrics.counter(
    "tempo_tpu_compiled_evictions_total",
    "Compiled-tier evictions (shape entries + cached programs), from "
    "the LRU cap or a governor pressure shed",
)


@dataclasses.dataclass
class CompiledConfig:
    """Config section `compiled` (kill switch analog
    TEMPO_TPU_COMPILED=0). max_shapes=0 means uncapped — check_config
    warns in multitenant mode, where tenant-controlled query text can
    mint shapes."""

    enabled: bool = True
    # LRU cap on distinct normalized shapes (0 = uncapped)
    max_shapes: int = 0
    # False detaches the executable cache from governor pressure sheds
    respect_governor: bool = True


# governor pressure -> surviving fraction of shape entries; programs
# clear at ANY pressure, as in the reference (they are rebuilt on
# demand — a recompile is cheaper than an OOM'd ingest path)
_PRESSURE_FACTORS = {0: 1.0, 1: 0.25, 2: 0.0}


class _ShapeEntry:
    __slots__ = ("lowerable", "hits")

    def __init__(self, lowerable: bool):
        self.lowerable = lowerable
        self.hits = 0


class ShapeCache:
    """Process-wide LRU of normalized-shape entries + the program
    registry the executor compiles into. Thread-safe; every lookup
    sheds first (cheap under budget), mirroring DeviceTier."""

    def __init__(self, max_shapes: int = 0, governor=None,
                 respect_governor: bool = True):
        self.max_shapes = int(max_shapes)
        self.respect_governor = respect_governor
        self._governor = governor  # None = process governor, bound lazily
        self._lock = threading.Lock()
        self._shapes: OrderedDict = OrderedDict()
        self._programs: dict = {}
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.evictions = 0

    # -- pressure ------------------------------------------------------
    def _level(self) -> int:
        gov = self._governor
        if gov is None:
            from tempo_tpu_torch.util import resource

            gov = self._governor = resource.governor()
        return gov.level()

    def shed(self) -> int:
        """Drop entries down to the pressure-scaled cap. Under any
        pressure the program registry clears too (device executables
        are the expensive half)."""
        if not self.respect_governor:
            return 0
        level = self._level()
        factor = _PRESSURE_FACTORS.get(level, 1.0)
        n = 0
        with self._lock:
            if level > 0 and self._programs:
                n += len(self._programs)
                self._programs.clear()
            keep = int(len(self._shapes) * factor) if factor < 1.0 else None
            if keep is not None:
                while len(self._shapes) > keep:
                    self._shapes.popitem(last=False)
                    n += 1
        if n:
            self.evictions += n
            compiled_evictions_total.inc(n)
        return n

    # -- shapes --------------------------------------------------------
    def lookup(self, key: str):
        """(entry, hit): the entry for a normalized shape, counting the
        hit/miss. A miss returns (None, False) — the caller lowers and
        store()s the verdict."""
        self.shed()
        with self._lock:
            e = self._shapes.get(key)
            if e is not None:
                self._shapes.move_to_end(key)
                e.hits += 1
                self.hits += 1
            else:
                self.misses += 1
        if e is not None:
            compiled_hits_total.inc()
        else:
            compiled_misses_total.inc()
        return e, e is not None

    def store(self, key: str, lowerable: bool) -> None:
        with self._lock:
            if key in self._shapes:
                self._shapes[key].lowerable = lowerable
                self._shapes.move_to_end(key)
                return
            self._shapes[key] = _ShapeEntry(lowerable)
            dropped = 0
            while self.max_shapes and len(self._shapes) > self.max_shapes:
                self._shapes.popitem(last=False)
                dropped += 1
        if dropped:
            self.evictions += dropped
            compiled_evictions_total.inc(dropped)

    # -- programs ------------------------------------------------------
    def program(self, sig, build):
        """The fused program for one static signature, built (and
        counted as a compile) at most once per signature while cached."""
        with self._lock:
            fn = self._programs.get(sig)
        if fn is not None:
            return fn
        fn = build(sig)
        with self._lock:
            won = self._programs.setdefault(sig, fn)
        if won is fn:
            self.compiles += 1
            compiled_compiles_total.inc()
        return won

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "shapes": len(self._shapes),
                "programs": len(self._programs),
                "maxShapes": self.max_shapes,
                "hits": self.hits,
                "misses": self.misses,
                "compiles": self.compiles,
                "evictions": self.evictions,
            }

    def clear(self) -> None:
        with self._lock:
            self._shapes.clear()
            self._programs.clear()


_shared: ShapeCache | None = None
_shared_lock = threading.Lock()
_config = CompiledConfig()


def enabled() -> bool:
    """The kill switch: TEMPO_TPU_COMPILED=0 (env wins) or
    compiled.enabled=false disables the tier — every query takes the
    interpreter, bit-identically."""
    env = os.environ.get("TEMPO_TPU_COMPILED", "")
    if env == "0":
        return False
    return _config.enabled


def configure(cfg: CompiledConfig | None) -> None:
    """Apply the app's `compiled:` section (App boot). Reconfiguring
    replaces the cap on the shared cache without dropping entries."""
    global _config
    if cfg is None:
        cfg = CompiledConfig()
    _config = cfg
    with _shared_lock:
        if _shared is not None:
            _shared.max_shapes = int(cfg.max_shapes)
            _shared.respect_governor = cfg.respect_governor


def shape_cache() -> ShapeCache:
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                _shared = ShapeCache(
                    max_shapes=_config.max_shapes,
                    respect_governor=_config.respect_governor,
                )
    return _shared
