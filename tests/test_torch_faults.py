"""The port's fault plan against the JAX package's.

`TEMPO_TPU_FAULTS` arms a seeded FaultPlan that make_raw_backend wraps
around every backend it builds. The same sequence of operations on a
MockBackend behind each package's FaultInjectingBackend must draw the
same faults in the same order: the errors compared by class name and
operation, damaged bytes byte for byte. The plans are parsed from the
environment variable itself, through each package's make_raw_backend.
"""

import logging

import numpy as np
import pytest

from tempo_tpu import backend as jbackend
from tempo_tpu.backend import faults as jfaults
from tempo_tpu_torch import backend as tbackend
from tempo_tpu_torch.backend import faults as tfaults

PLANS = ["read=0.3,seed=7", "notfound=1.0,seed=7", "corrupt=0.5,seed=3", "short=1.0,seed=11",
         "all=0.2,write=0.05,latency=0.5,latency_s=0,fail_every=7,seed=5"]


def _ops(seed: int = 0, n: int = 160) -> list[tuple]:
    """A seeded mix of backend operations over a handful of objects."""
    rng = np.random.default_rng(seed)
    names = [f"obj-{i}" for i in range(6)]
    out = [("write", n_, ("t", "b"), bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
           for n_ in names]
    kinds = ["read", "read_range", "write", "append", "list", "list_objects", "delete"]
    for _ in range(n):
        k = kinds[int(rng.integers(0, len(kinds)))]
        name = names[int(rng.integers(0, len(names)))]
        if k in ("write", "append"):
            out.append((k, name, ("t", "b"), bytes(rng.integers(0, 256, 16, dtype=np.uint8))))
        elif k == "read_range":
            out.append((k, name, ("t", "b"), int(rng.integers(0, 16)), int(rng.integers(1, 48))))
        elif k in ("list", "list_objects"):
            out.append((k, ("t",)))
        else:
            out.append((k, name, ("t", "b")))
    return out


def _run(be, ops) -> list[tuple]:
    """Each op's outcome: ("ok", value) or ("err", class name, op)."""
    out = []
    for op in ops:
        try:
            v = getattr(be, op[0])(*op[1:])
            out.append(("ok", v if isinstance(v, (bytes, list)) else None))
        except Exception as e:  # noqa: BLE001 — the outcome is the point
            out.append(("err", type(e).__name__, op[0]))
    return out


@pytest.mark.parametrize("spec", PLANS)
def test_same_fault_sequence_as_the_reference(spec, monkeypatch, caplog):
    monkeypatch.setenv("TEMPO_TPU_FAULTS", spec)
    with caplog.at_level(logging.WARNING):
        jbe = jbackend.make_raw_backend("mock")
        tbe = tbackend.make_raw_backend("mock")
    assert isinstance(jbe, jfaults.FaultInjectingBackend)
    assert isinstance(tbe, tfaults.FaultInjectingBackend)
    assert type(tbe.inner).__name__ == type(jbe.inner).__name__ == "MockBackend"
    assert vars(tbe.plan) == vars(jbe.plan)
    # the reference's warning, once per package
    armed = [r.getMessage() for r in caplog.records if "TEMPO_TPU_FAULTS is armed" in r.getMessage()]
    assert armed == ["TEMPO_TPU_FAULTS is armed — backend MockBackend runs behind fault injection"] * 2
    for seed in range(3):
        ops = _ops(seed)
        jout, tout = _run(jbe, ops), _run(tbe, ops)
        assert tout == jout
        assert tbe.inner.objects == jbe.inner.objects
    assert dict(tbe.injected) == dict(jbe.injected)
    assert sum(tbe.injected.values()) > 0


def test_every_plan_injects_what_it_names(monkeypatch):
    """Each of the four plans draws its own fault class, so the sequences above
    compare something: read errors, NotFound flaps, bit flips, short
    reads."""
    want = {"read=0.3,seed=7": "error:read", "notfound=1.0,seed=7": "notfound",
            "corrupt=0.5,seed=3": "corrupt", "short=1.0,seed=11": "short_read"}
    for spec, kind in want.items():
        monkeypatch.setenv("TEMPO_TPU_FAULTS", spec)
        be = tbackend.make_raw_backend("mock")
        _run(be, _ops(0))
        assert be.injected[kind] > 0, spec


def test_unarmed_backend_is_not_wrapped(monkeypatch):
    monkeypatch.delenv("TEMPO_TPU_FAULTS", raising=False)
    assert tfaults.env_plan() is None
    assert isinstance(tbackend.make_raw_backend("mock"), tbackend.MockBackend)
    monkeypatch.setenv("TEMPO_TPU_FAULTS", "  ")
    assert tfaults.env_plan() is None


@pytest.mark.parametrize("spec", ["read=0.05,corrupt=0.001,seed=7,latency=0.1",
                                  "notfound=0.5,short=0.25,latency_s=0.5,fail_every=3",
                                  "all=0.1,list=0,delete=1"])
def test_spec_parses_as_the_reference(spec):
    assert vars(tfaults.FaultPlan.from_spec(spec)) == vars(jfaults.FaultPlan.from_spec(spec))


def test_unknown_spec_key_rejected():
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError, match="unknown fault spec key"):
            mod.FaultPlan.from_spec("read=0.1,bogus=3")


def test_mix_and_roll_equal():
    rng = np.random.default_rng(3)
    for _ in range(500):
        parts = [int(x) for x in rng.integers(-(1 << 62), 1 << 62, int(rng.integers(1, 5)))]
        assert tfaults._mix(*parts) == jfaults._mix(*parts)
        seed, n, salt = (int(x) for x in rng.integers(0, 1 << 31, 3))
        for op in ("read", "read_range", "rc_fetch"):
            assert tfaults._roll(seed, op, n, salt) == jfaults._roll(seed, op, n, salt)


def test_deny_names_simulates_a_crash_before_commit():
    """deny_names: a meta.json write always fails, data writes pass."""
    plan = dict(deny_names=("meta.json",))
    outs = []
    for mod, mock in ((jfaults, jbackend.MockBackend), (tfaults, tbackend.MockBackend)):
        be = mod.FaultInjectingBackend(mock(), mod.FaultPlan(**plan))
        outs.append(_run(be, [("write", "data.bin", ("t", "b"), b"x"),
                              ("write", "meta.json", ("t", "b"), b"{}"),
                              ("read", "meta.json", ("t", "b"))]))
        assert dict(be.injected) == {"deny": 1}
    assert outs[0] == outs[1] == [("ok", None), ("err", "OSError", "write"),
                                  ("err", "NotFound", "read")]


def test_plan_swap_heals_the_backend():
    be = tfaults.FaultInjectingBackend(tbackend.MockBackend(),
                                       tfaults.FaultPlan(error_rates={"all": 1.0}))
    with pytest.raises(IOError):
        be.write("a", ("t",), b"1")
    be.plan = tfaults.FaultPlan()
    be.write("a", ("t",), b"1")
    assert be.read("a", ("t",)) == b"1"
