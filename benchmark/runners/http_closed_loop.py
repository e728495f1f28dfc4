"""Closed-loop HTTP clients against the single binary (a query cell).

The server runs in a process of its own (`benchmark/launcher.py`), which
writes the configuration's blocks on the card and then serves them. This
process never touches the card: it makes the same data from the seed for
the reference, warms the mix up until a pass compiles and admits nothing
more, then runs `clients` closed-loop clients for the window, each
taking its next request from one shared sequence of passes over the mix's
deck (`benchmark.traffic`) when its last is answered. The window starts
passes until `--seconds` have passed and finishes the pass under way, so
a run's work is whole passes: the rate is the answered requests over the
time from the window's start to the last answer. After the window it
judges every answer against the reference.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

from benchmark import common, datasets, reference
from benchmark.traffic import Mix

READY_TIMEOUT_S = 600


class Client:
    def __init__(self, port: int, tenant: str):
        self.port, self.tenant = port, tenant
        self.conn = None

    def get(self, path: str, timeout: float = 300.0) -> tuple:
        """(status, parsed body or None); a broken connection is retried once."""
        for attempt in (0, 1):
            try:
                if self.conn is None:
                    self.conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                           timeout=timeout)
                self.conn.request("GET", path, headers={"X-Scope-OrgID": self.tenant})
                r = self.conn.getresponse()
                body = r.read()
                try:
                    return r.status, json.loads(body)
                except ValueError:
                    return r.status, None
            except (OSError, http.client.HTTPException):
                if self.conn is not None:
                    self.conn.close()
                self.conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def close(self):
        if self.conn is not None:
            self.conn.close()


class Feed:
    """The one sequence of requests the clients take from: passes over the
    deck. Past `until` the pass under way is finished and no new one
    starts; `limit` caps the requests taken so far."""

    def __init__(self, passes, until: float = float("inf")):
        self.passes, self.until = passes, until
        self.limit = 0
        self.taken = 0
        self._queue: list = []
        self._lock = threading.Lock()

    def take(self):
        with self._lock:
            if self.limit and self.taken >= self.limit:
                return None
            if not self._queue:
                if time.perf_counter() >= self.until:
                    return None
                self._queue = list(reversed(next(self.passes)))
            self.taken += 1
            return self._queue.pop()


def _loop(client: Client, feed: Feed, out: list):
    """Sends the feed's next request when the last is answered, until the
    feed runs dry."""
    while (req := feed.take()) is not None:
        t0 = time.perf_counter()
        try:
            status, doc = client.get(req["path"])
        except (OSError, http.client.HTTPException) as e:
            status, doc = 0, {"error": repr(e)}
        out.append({"req": req, "t0": t0, "t1": time.perf_counter(), "status": status,
                    "doc": doc})


def _run_clients(port: int, tenant: str, feed: Feed, n_clients: int) -> list:
    outs = [[] for _ in range(n_clients)]
    clients = [Client(port, tenant) for _ in range(n_clients)]
    threads = [threading.Thread(target=_loop, args=(c, feed, o), daemon=True)
               for c, o in zip(clients, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(1.0, feed.until - time.perf_counter()) + 900
               if feed.until != float("inf") else 900)
    for c in clients:
        c.close()
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not finish within 900 s of the window's close")
    return [r for o in outs for r in o]


def _counters(client: Client) -> dict:
    st1, insights = client.get("/api/query-insights?limit=1")
    st2, device = client.get("/status/device?top=1")
    if st1 != 200 or st2 != 200:
        raise RuntimeError(f"counters: /api/query-insights {st1}, /status/device {st2}")
    tier = device.get("residentTier", {})
    return {"compiled": insights.get("compiled", {}),
            "transfer": device.get("transfer", {}).get("totals", {}),
            "tier": tier.get("stats", {}) if tier.get("enabled") else {}}


def _wait_ready(client: Client, proc, log_path: str) -> None:
    deadline = time.perf_counter() + READY_TIMEOUT_S
    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"the server exited with {proc.returncode}:\n" + _tail(log_path))
        try:
            if client.get("/ready", timeout=5)[0] == 200:
                return
        except (OSError, http.client.HTTPException):
            pass
        time.sleep(0.2)
    raise RuntimeError("the server was not ready in time:\n" + _tail(log_path))


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _wait_file(path: str, proc, timeout: float, log_path: str) -> None:
    deadline = time.perf_counter() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise RuntimeError(f"the server exited with {proc.returncode}:\n" + _tail(log_path))
        if time.perf_counter() > deadline:
            raise RuntimeError(f"no {os.path.basename(path)} within {timeout} s")
        time.sleep(0.01)


def _server_cpu_s(pid: int) -> float | None:
    """The server process's CPU seconds (user and system, all its threads),
    from /proc; None where they cannot be read."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def latency_notes(records: list, seconds: float, cpu0, cpu1) -> dict:
    """What a run's notes say of its window: quantiles of the answered
    requests' latencies (ms), the longest, and the server's CPU seconds a
    request."""
    ms = sorted((r["t1"] - r["t0"]) * 1e3 for r in records if r["status"] == 200)
    out = {"seconds": seconds}
    if len(ms) >= 10:
        q, p50 = statistics.quantiles(ms, n=10), statistics.median(ms)
        out["latency_ms"] = {"p10": q[0], "p50": p50, "p90": q[-1], "max": ms[-1],
                             "over_2x_p50": sum(x > 2 * p50 for x in ms)}
    if cpu0 is not None and cpu1 is not None and ms:
        out["server_cpu_s_per_query"] = (cpu1 - cpu0) / len(ms)
    return out


def _warm(port: int, cell, mix: Mix, probe: Client) -> dict:
    """Runs passes of the mix (`requests` requests each, from passes over
    the deck) until `min_passes` have run and the last changed none of the
    counters a pass can move: the compiled tier's compiles and the device
    tier's admissions and bytes, or until `max_s` have passed."""
    w = cell.traffic["warmup"]
    feed = Feed(mix.passes(datasets.rng(cell.seed, 100)))
    t_start = time.perf_counter()
    last, passes = None, 0
    while True:
        feed.limit = feed.taken + w["requests"]
        recs = _run_clients(port, cell.config["tenant"], feed, mix.t["clients"])
        bad = [r for r in recs if r["status"] != 200]
        if bad:
            raise RuntimeError(f"warm-up: {len(bad)} requests failed, e.g. "
                               f"{bad[0]['status']} {json.dumps(bad[0]['doc'])[:400]}")
        passes += 1
        c = _counters(probe)
        now = (c["tier"].get("admissions"), c["tier"].get("bytes"), c["compiled"].get("compiles"))
        settled = passes >= w["min_passes"] and now == last
        t = time.perf_counter() - t_start
        if settled or t >= w["max_s"]:
            return {"passes": passes, "settled": settled, "seconds": t, "tier": c["tier"],
                    "compiled": c["compiled"]}
        last = now


def run(cell) -> dict:
    mix = Mix(cell.traffic, cell.config)
    run_dir = tempfile.mkdtemp(prefix="bench-")
    log_path = os.path.join(run_dir, "server.log")
    port = common.free_port()
    cmd = [sys.executable, os.path.join(common.ROOT, "benchmark", "launcher.py"),
           "--config", cell.config_path, "--seed", str(cell.seed), "--dir", run_dir,
           "--port", str(port), "--trace", str(int(cell.trace)), "--device", cell.device]
    if cell.fault:
        cmd += ["--fault", cell.fault]
    env = dict(os.environ, **common.cache_env())
    env["PYTHONPATH"] = common.ROOT + os.pathsep + env.get("PYTHONPATH", "")
    log = open(log_path, "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                            cwd=common.ROOT)
    probe = Client(port, cell.config["tenant"])
    try:
        blocks = datasets.blocks(cell.config, cell.seed)  # the reference's, meanwhile
        _wait_ready(probe, proc, log_path)
        warm = _warm(port, cell, mix, probe)
        before = _counters(probe)
        alive = lambda: proc.poll() is None  # noqa: E731
        common.signal(os.path.join(run_dir, "window_start"), alive)
        _wait_file(os.path.join(run_dir, "window_started"), proc, 120, log_path)
        cpu0 = _server_cpu_s(proc.pid)
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        until = t0 + cell.seconds
        recs = _run_clients(port, cell.config["tenant"],
                            Feed(mix.passes(datasets.rng(cell.seed, 200)), until),
                            mix.t["clients"])
        t_last = max((r["t1"] for r in recs), default=until)
        cpu1 = _server_cpu_s(proc.pid)
        common.signal(os.path.join(run_dir, "window_stop"), alive)
        _wait_file(os.path.join(run_dir, "window.json"), proc, 300, log_path)
        with open(os.path.join(run_dir, "window.json")) as f:
            window = json.load(f)
        after = _counters(probe)
        trace = None
        if cell.trace:
            from benchmark import tracefile

            trace = tracefile.reduce(os.path.join(run_dir, "trace.json"))
    finally:
        probe.close()
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        server_log = _tail(log_path, 2000)
        shutil.rmtree(run_dir, ignore_errors=True)

    ok = [r for r in recs if r["status"] == 200]
    failed = [r for r in recs if r["status"] != 200]
    checks = _judge(cell, blocks, recs)
    return {
        "e2e": {cell.traffic["rate_metric"]: len(ok) / (t_last - t0)}, "setup_s": setup_s,
        "attempted": len(recs), "failed": len(failed),
        "checks": checks, "window": window, "trace": trace,
        "layer": {"records": recs, "seconds": t_last - t0, "before": before,
                  "after": after, "calls": window["calls"], "trace": trace,
                  "window_s": window["window_s"]},
        "notes": {"warmup": warm, "requests": len(recs),
                  "window": latency_notes(recs, t_last - t0, cpu0, cpu1),
                  "server_log_tail": server_log if failed else ""},
        "failed_examples": [json.dumps(r["doc"])[:300] for r in failed[:3]],
    }


def _judge(cell, blocks: list, recs: list) -> list:
    """[(name, reading, limit)] over every answered request."""
    judged = [r for r in recs if r["status"] == 200]
    failed = sum(r["status"] != 200 for r in recs)
    limits = cell.traffic["limits"]
    ref = reference.RangeReference(blocks)
    gap = max((reference.judge_query_range(ref, r["req"]["spec"], r["doc"]["data"]["result"])
               for r in judged), default=float("inf"))
    return [("failed_requests", failed, limits["failed_requests"]),
            ("count_gap", gap, limits["count_gap"])]
