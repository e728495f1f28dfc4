"""The port's tempo-cli (python -m tempo_tpu_torch.cli) against the JAX
package's.

A port App on the CPU writes the blocks (synthetic traces, call-chain
traces for the graph commands, vulture probes), and the backend
directory is copied for the reference: every read-only command prints
the same stdout and exits with the same code over the two copies. The
commands that write (gen bloom, gen index, convert) run on copies of
their own, and the objects they leave are byte-equal (gzip's clock
pinned: vrow1 records gzip the dictionary). gen bloom and convert run
with `--device cpu`; without it they want CUDA and raise here."""

import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

import chip_smoke
from tempo_tpu import cli as jcli
from tempo_tpu_torch import cli
from tempo_tpu_torch.app import App, AppConfig
from tempo_tpu_torch.db import DBConfig
from tempo_tpu_torch.model import synth
from tempo_tpu_torch.model.trace import batch_to_traces
from tempo_tpu_torch.util import pageheat
from tempo_tpu_torch.vulture import InProcessClient, Vulture

TENANT = "single-tenant"
BASE = 1_700_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


@pytest.fixture(autouse=True)
def gzip_clock(monkeypatch):
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: BASE))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """(root, block ids, traces, snapshot path): two blocks written by a
    port App, copied to root/p and root/j."""
    tmp = tmp_path_factory.mktemp("cli")
    app = App(AppConfig(db=DBConfig(backend="local", backend_path=str(tmp / "w" / "blocks"),
                                    wal_path=str(tmp / "w" / "wal"))), device="cpu")
    traces = [synth.make_trace(seed=i, n_spans=5) for i in range(6)]
    app.push_traces(traces)
    v = Vulture(InProcessClient(app), write_backoff_s=10)
    for i in range(3):
        v.write_once(BASE + 10 * i)
    app.sweep_all(immediate=True)
    app.push_traces(batch_to_traces(synth.make_graph_batch(24, 6, seed=3)))
    app.sweep_all(immediate=True)
    app.db.poll_now()
    ids = sorted(m.block_id for m in app.db.blocklist.metas(TENANT))
    assert len(ids) == 2
    from tempo_tpu_torch.encoding.common import SearchRequest

    app.db.search(TENANT, SearchRequest(tags={"service": "frontend"}, limit=0))
    snapshot = str(tmp / "device_ledger.json")
    with open(snapshot, "w") as f:
        json.dump(pageheat.PageHeatExporter().build_snapshot(), f)
    app.shutdown()
    for side in ("p", "j"):
        shutil.copytree(tmp / "w" / "blocks", tmp / side)
    return tmp, ids, traces, snapshot


def run_both(capsys, root, argv_tail, port_extra=()):
    """(port (rc, stdout), reference (rc, stdout)) over root/p and root/j."""
    out = []
    for main, side, extra in ((cli.main, "p", list(port_extra)), (jcli.main, "j", [])):
        rc = main(["--path", str(root / side), *argv_tail, *extra])
        out.append((rc, capsys.readouterr().out))
    return out


def _commands(ids, traces, snapshot):
    svc = traces[0].batches[0][0]["service.name"]
    return {
        "list tenants": ["list", "tenants"],
        "list blocks": ["list", "blocks", TENANT, "--include-compacted"],
        "list compaction-summary": ["list", "compaction-summary", TENANT],
        "list cache-summary": ["list", "cache-summary", TENANT],
        "view block": ["view", "block", TENANT, ids[0]],
        "view columns": ["view", "columns", TENANT, ids[1]],
        "query trace-id": ["query", "trace-id", TENANT, traces[0].trace_id.hex()],
        "query trace-id absent": ["query", "trace-id", TENANT, "0" * 32],
        "query search tags": ["query", "search", TENANT, "--tags", f"service.name={svc}"],
        "query search traceql": ["query", "search", TENANT, "--q",
                                 f'{{ resource.service.name = "{svc}" }}', "--limit", "3"],
        "query search-tags": ["query", "search-tags", TENANT],
        "query search-tag-values": ["query", "search-tag-values", TENANT, "service.name"],
        "analyse block": ["analyse", "block", TENANT, ids[0]],
        "analyse block json": ["analyse", "block", TENANT, ids[1], "--json"],
        "analyse blocks": ["analyse", "blocks", TENANT],
        "analyse device": ["analyse", "device", snapshot, "--budgets-mb", "1,4", "--resident"],
        "graph dependencies": ["graph", "dependencies", TENANT],
        "graph dependencies json": ["graph", "dependencies", TENANT, "--json"],
        "graph critical-path": ["graph", "critical-path", TENANT, "--by", "name"],
        "graph critical-path json": ["graph", "critical-path", TENANT, "--json"],
        "vulture-check": ["vulture-check", TENANT, "--write-backoff", "10",
                          "--since", str(BASE), "--until", str(BASE + 20)],
        "vulture-check phantom slots": ["vulture-check", TENANT, "--write-backoff", "5",
                                        "--since", str(BASE), "--until", str(BASE + 20)],
    }


COMMANDS = list(_commands(["b0", "b1"], [synth.make_trace(seed=0, n_spans=5)], "s"))


@pytest.mark.parametrize("name", COMMANDS)
def test_read_only_command_equal(store, capsys, name):
    root, ids, traces, snapshot = store
    argv = _commands(ids, traces, snapshot)[name]
    port, ref = run_both(capsys, root, argv)
    assert port == ref
    rc, out = port
    if name in ("query trace-id absent", "vulture-check phantom slots"):
        assert rc == 1
    else:
        assert rc == 0 and out
    if name == "query trace-id":
        doc = json.loads(out)
        spans = [s for rs in doc["resourceSpans"] for ss in rs["scopeSpans"] for s in ss["spans"]]
        assert len(spans) == traces[0].span_count()
    if name == "vulture-check":
        assert "found=3" in out and "missing=0" in out


def test_gen_bloom_objects_equal(store, tmp_path, capsys):
    root, ids, _, _ = store
    for side in ("p", "j"):
        shutil.copytree(root / side, tmp_path / side)
    blooms_before = chip_smoke.block_objects(str(tmp_path / "p"), TENANT, ids[1])
    port, ref = run_both(capsys, tmp_path, ["gen", "bloom", TENANT, ids[1]],
                         port_extra=["--device", "cpu"])
    assert port == ref and port[0] == 0 and "rebuilt" in port[1]
    after = chip_smoke.block_objects(str(tmp_path / "p"), TENANT, ids[1])
    assert after == chip_smoke.block_objects(str(tmp_path / "j"), TENANT, ids[1])
    assert {k: v for k, v in after.items() if k.startswith("bloom")} == \
        {k: v for k, v in blooms_before.items() if k.startswith("bloom")}


def test_gen_and_list_index(store, tmp_path, capsys):
    root, ids, _, _ = store
    for side in ("p", "j"):
        shutil.copytree(root / side, tmp_path / side)
    assert run_both(capsys, tmp_path, ["gen", "index", TENANT])[0] == \
        (0, "wrote tenant index: 2 blocks, 0 compacted\n")
    port, ref = run_both(capsys, tmp_path, ["list", "index", TENANT])
    docs = [json.loads(o) for _, o in (port, ref)]
    for d in docs:
        d.pop("created_at")
    assert docs[0] == docs[1] and docs[0]["blocks"] == ids


def test_convert_round_trip_objects_equal(store, tmp_path, capsys):
    """vtpu1 -> vrow1 -> vtpu1 in both packages: the same stdout (block
    ids aside), byte-equal vrow1 blocks, and a final vtpu1 block equal to
    the source."""
    root, ids, traces, _ = store
    for side in ("p", "j"):
        shutil.copytree(root / side, tmp_path / side)
    src = ids[0]
    new_ids = {}
    for to, source in (("vrow1", {"p": src, "j": src}), ("vtpu1", None)):
        source = source or new_ids
        outs = {}
        for main, side, extra in ((cli.main, "p", ["--device", "cpu"]), (jcli.main, "j", [])):
            rc = main(["--path", str(tmp_path / side), "convert", TENANT, source[side],
                       "--to", to, *extra])
            out = capsys.readouterr().out
            assert rc == 0 and f"({to})" in out
            new_ids[side] = UUID.findall(out)[1]
            outs[side] = UUID.sub("ID", out)
        assert outs["p"] == outs["j"]
        a = chip_smoke.block_objects(str(tmp_path / "p"), TENANT, new_ids["p"], drop_id=True)
        b = chip_smoke.block_objects(str(tmp_path / "j"), TENANT, new_ids["j"], drop_id=True)
        assert a == b
    assert a == chip_smoke.block_objects(str(tmp_path / "p"), TENANT, src, drop_id=True)


@pytest.mark.parametrize("as_json", [False, True])
def test_rca_replay_equal(tmp_path, capsys, as_json):
    bundle = tmp_path / "incident.json"
    bundle.write_text(json.dumps({
        "finding": {"cause": "handoff_dip"},
        "evidence": {
            "vultureErrors": [{"type": "handoff_dip", "tier": "fresh", "count": 1},
                              {"type": "request_failed", "tier": "aged", "count": 5}],
            "breakers": {"query-backend": {"state": 2, "stateName": "open"}},
            "stageSeconds": {"merge": 0.5, "fetch": 2.0},
            "walks": {"edgeVisits": {"a->b": 9, "b->c": 3}, "serverVisits": {"b": 9, "c": 3}},
            "exemplarTraceIds": ["ab" * 16],
        }}))
    argv = ["--path", str(tmp_path), "rca", "replay", str(bundle)] + (["--json"] if as_json else [])
    got = []
    for main in (cli.main, jcli.main):
        got.append((main(argv), capsys.readouterr().out))
    assert got[0] == got[1] and got[0][0] == 0
    assert "backend_fault" in got[0][1]


@pytest.mark.parametrize("argv", [["gen", "bloom", TENANT], ["convert", TENANT]])
def test_device_commands_want_cuda(store, argv):
    """gen bloom and convert default to --device cuda: without CUDA they
    raise rather than run on the host."""
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    root, ids, _, _ = store
    tail = [ids[0]] + (["--to", "vrow1"] if argv[0] == "convert" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--path", str(root / "p"), *argv, *tail])


def test_module_entry_point(store, capsys):
    """python -m tempo_tpu_torch.cli prints what main() prints."""
    root, ids, _, _ = store
    argv = ["--path", str(root / "p"), "list", "blocks", TENANT]
    proc = subprocess.run([sys.executable, "-m", "tempo_tpu_torch.cli", *argv],
                          capture_output=True, text=True, cwd=REPO, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert cli.main(argv) == 0
    assert proc.stdout == capsys.readouterr().out
    assert all(i in proc.stdout for i in ids)
