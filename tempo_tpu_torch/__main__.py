"""Process entry point: `python -m tempo_tpu_torch -config.file=tempo.yaml`.

Port of tempo_tpu/__main__.py (reference: cmd/tempo/main.go — flags +
YAML config with envsubst, config sanity warnings, then the app). The
single-binary `-target=all` composition runs every role in-process on
the CUDA device, the metrics-generator among them (on by default, as in
the reference); any other `-target` of app.ROLES runs one role of
microservices mode, which finds its peers through the YAML's top-level
`ring_kv_path` or `ring_kv_url` and advertises `advertise_addr` (a
querier pulls jobs from `frontend_address`). `-device cpu` runs on the
host. `-config.verify` validates and exits. The gRPC, Jaeger UDP and
Kafka receivers wait for a later slice (ROADMAP Queue 1 item 8, cited
as item 2): a config that turns one on is refused, as App refuses every
other section whose module is not ported.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App, refuse_unported
from tempo_tpu_torch.config import Config, check_config, load_config


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tempo-tpu")
    p.add_argument("-config.file", dest="config_file", default="", help="YAML config path")
    p.add_argument("-config.verify", dest="verify", action="store_true",
                   help="validate config and exit")
    p.add_argument("-target", dest="target", default="",
                   help="role to run (all | distributor | ... ; overrides config)")
    p.add_argument("-server.http-listen-port", dest="port", type=int, default=0)
    p.add_argument("-device", dest="device", default=None,
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)

    cfg = load_config(args.config_file) if args.config_file else Config()
    if args.target:
        cfg.target = args.target
    if args.port:
        cfg.server.http_listen_port = args.port

    logging.basicConfig(
        level=getattr(logging, cfg.server.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("tempo_tpu_torch")

    for w in check_config(cfg):
        log.warning("config check: %s", w)
    srv = cfg.server
    if srv.grpc_listen_port or srv.jaeger_agent_compact_port \
            or srv.jaeger_agent_binary_port or srv.kafka.brokers:
        raise NotImplementedError(
            "tempo_tpu_torch: the gRPC, Jaeger UDP and Kafka receivers are not "
            "ported yet (ROADMAP Queue 1 item 2 (single binary: the other "
            "receivers))")
    cfg.app.target = cfg.target
    refuse_unported(cfg.app)
    if args.verify:
        print("config ok")
        return 0

    app = App(cfg.app, device=args.device)
    stop = threading.Event()
    # lets the HTTP /shutdown handler terminate this process after its
    # drain (reference ShutdownHandler semantics); set before the
    # listener opens, so a /shutdown that follows the first /ready is
    # never answered "not terminating"
    app.on_shutdown_request = stop.set
    server = TempoServer(
        app, host=cfg.server.http_listen_address, port=cfg.server.http_listen_port
    ).start()
    app.start_loops()
    log.info("tempo-tpu up: target=%s device=%s listening on %s",
             cfg.target, app.device, server.url)

    def handle(sig, frame):
        log.info("signal %s: shutting down", sig)
        stop.set()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)
    stop.wait()
    server.stop()
    app.shutdown()
    log.info("tempo-tpu stopped cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
