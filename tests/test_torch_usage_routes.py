"""The usage routes of the port's single binary against the JAX package's.

`GET /api/usage` (the caller's tenant only), `/status/usage` (every
tenant) and `/status/usage-stats` are asked of both packages' App behind
their TempoServer (tests/test_torch_app.AppPair, the port on the CPU)
and compared field for field: on fresh Apps, after the same OTLP pushes
under two tenants, and after the same tag search. Both packages'
process-wide accountants are cleared first, so each holds only what the
test sent. The one field left out is `device_seconds`, a wall clock; its
presence is compared. Tolerance is exact: every other field is a count
of bytes, spans, pages or dispatches.
"""

import json

import pytest

from tempo_tpu.util import usage as jusage
from tempo_tpu_torch.util import usage

from test_torch_app import PB, AppPair, T0, otlp, qs, traces_of

WALL_CLOCK = ("device_seconds",)


def _norm(raw: bytes):
    """A usage document with each wall-clock field replaced by whether
    it is there."""
    def walk(x):
        if isinstance(x, dict):
            return {k: (k in x) if k in WALL_CLOCK else walk(v) for k, v in x.items()}
        return x

    return walk(json.loads(raw))


@pytest.fixture
def pair(tmp_path, monkeypatch):
    for mod in (jusage, usage):
        monkeypatch.setattr(mod, "ACCOUNTANT", mod.UsageAccountant())
    p = AppPair(tmp_path, multitenancy_enabled=True)
    yield p
    p.close()


def _push(pair, org: str, seed: int) -> None:
    body = otlp.encode_traces_request(traces_of(8, 3, seed=seed))
    status, _ = pair.same("POST", "/v1/traces", body, dict(PB, **{"X-Scope-OrgID": org}))
    assert status == 200


@pytest.mark.parametrize("path", ["/api/usage", "/status/usage", "/status/usage-stats"])
def test_usage_routes_on_fresh_apps(pair, path):
    status, body = pair.same("GET", path, headers={"X-Scope-OrgID": "a"}, norm=_norm)
    assert status == 200
    doc = json.loads(body)
    if path == "/api/usage":
        assert doc == {"tenant": "a", "kinds": {}, "total": {}}
    elif path == "/status/usage":
        assert doc["tenants"] == {} and "ingested_bytes" in doc["fields"]
    else:
        assert doc == {"enabled": False}


def test_usage_routes_after_pushes_and_a_search(pair):
    _push(pair, "a", seed=1)
    _push(pair, "b", seed=2)
    _push(pair, "a", seed=3)
    docs = {}
    for org in ("a", "b"):
        status, body = pair.same("GET", "/api/usage", headers={"X-Scope-OrgID": org}, norm=_norm)
        docs[org] = json.loads(body)
        assert status == 200 and docs[org]["tenant"] == org
        assert docs[org]["total"]["ingested_spans"] == 24 * (2 if org == "a" else 1)
    assert docs["a"]["kinds"]["ingest"]["ingested_bytes"] > \
        docs["b"]["kinds"]["ingest"]["ingested_bytes"] > 0
    assert pair.same("POST", "/flush")[0] in (200, 204)
    status, _ = pair.same("GET", "/api/search" + qs(tags="service.name=cart", start=T0,
                                                    end=T0 + 3600),
                          headers={"X-Scope-OrgID": "a"},
                          norm=lambda b: json.loads(b)["traces"])
    assert status == 200
    status, body = pair.same("GET", "/status/usage", norm=_norm)
    doc = json.loads(body)
    assert status == 200 and sorted(doc["tenants"]) == ["a", "b"]
    assert "search" in doc["tenants"]["a"]["kinds"] and "search" not in doc["tenants"]["b"]["kinds"]
    status, body = pair.same("GET", "/api/usage", headers={"X-Scope-OrgID": "b"}, norm=_norm)
    after = json.loads(body)
    assert after["kinds"]["ingest"]["flushed_bytes"] > 0  # the flush wrote b's block
    assert {k: v for k, v in after["total"].items() if k != "flushed_bytes"} == docs["b"]["total"]
    status, body = pair.same("GET", "/status/usage-stats", norm=_norm)
    assert status == 200 and json.loads(body) == {"enabled": False}
