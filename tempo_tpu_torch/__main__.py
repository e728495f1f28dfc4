"""Process entry point: `python -m tempo_tpu_torch -config.file=tempo.yaml`.

Port of tempo_tpu/__main__.py (reference: cmd/tempo/main.go — flags +
YAML config with envsubst, config sanity warnings, then the app). The
single-binary `-target=all` composition runs every role in-process on
the CUDA device, the metrics-generator among them (on by default, as in
the reference); any other `-target` of app.ROLES runs one role of
microservices mode, which finds its peers through the YAML's top-level
`ring_kv_path` or `ring_kv_url` and advertises `advertise_addr` (a
querier pulls jobs from `frontend_address`). `-device cpu` runs on the
host. `-config.verify` validates and exits. On target all and
distributor the receivers that `server:` turns on start beside the HTTP
listener (start_receivers): OTLP, Jaeger and OpenCensus over gRPC
(`grpc_listen_port`; needs grpcio), the Jaeger agent over UDP
(`jaeger_agent_compact_port`, `jaeger_agent_binary_port`) and Kafka
(`kafka.brokers`); they stop before the App at shutdown.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from tempo_tpu_torch.api.server import TempoServer
from tempo_tpu_torch.app import App
from tempo_tpu_torch.config import Config, check_config, load_config

log = logging.getLogger("tempo_tpu_torch")


def start_receivers(cfg: Config, app: App) -> list:
    """Start the gRPC, Jaeger agent UDP and Kafka receivers that the
    config turns on (target all or distributor only), each pushing into
    `app`; returns them in start order, each with a stop()."""
    started: list = []
    if cfg.target not in ("all", "distributor"):
        return started
    srv = cfg.server
    if srv.grpc_listen_port:
        from tempo_tpu_torch.receivers.grpc_server import TraceGrpcServer

        grpc_server = TraceGrpcServer(
            app.push_traces, host=srv.http_listen_address, port=srv.grpc_listen_port,
        ).start()
        started.append(grpc_server)
        log.info("OTLP/Jaeger/OpenCensus gRPC receiver on :%d", grpc_server.port)
    if srv.jaeger_agent_compact_port or srv.jaeger_agent_binary_port:
        from tempo_tpu_torch.receivers.udp import UDPAgentServer

        udp_rx = UDPAgentServer(
            app.push_traces,
            host=srv.http_listen_address,
            compact_port=srv.jaeger_agent_compact_port or None,
            binary_port=srv.jaeger_agent_binary_port or None,
        ).start()
        started.append(udp_rx)
        log.info("Jaeger agent UDP receiver on compact:%d binary:%d",
                 udp_rx.compact_port, udp_rx.binary_port)
    if srv.kafka.brokers:
        from tempo_tpu_torch.receivers.kafka import KafkaReceiver

        kafka_rx = KafkaReceiver(
            app.push_traces,
            brokers=list(srv.kafka.brokers),
            topic=srv.kafka.topic,
            poll_interval_s=srv.kafka.poll_interval_s,
            group_id=srv.kafka.group_id or None,
        ).start()
        started.append(kafka_rx)
        log.info("Kafka receiver consuming %s from %s (group=%s)",
                 srv.kafka.topic, srv.kafka.brokers, srv.kafka.group_id or "<none>")
    return started


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

    for w in check_config(cfg):
        log.warning("config check: %s", w)
    cfg.app.target = cfg.target
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
    receivers = start_receivers(cfg, app)
    app.start_loops()
    log.info("tempo-tpu up: target=%s device=%s listening on %s",
             cfg.target, app.device, server.url)

    def handle(sig, frame):
        log.info("signal %s: shutting down", sig)
        stop.set()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)
    stop.wait()
    for rx in reversed(receivers):
        rx.stop()
    server.stop()
    app.shutdown()
    log.info("tempo-tpu stopped cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
