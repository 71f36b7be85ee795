"""CLI entry point.

Reference parity: cmd/server/main.go (startServer :250-304, getConfig
:191) and commands.go (generate-keys, create-join-token, list-nodes,
ports). Flags are generated from the config schema exactly like the
reference's GenerateCLIFlags (main.go:126).

Usage:
    python -m livekit_server_tpu_torch serve --dev [--device cpu]
    python -m livekit_server_tpu_torch serve --config livekit.yaml
    python -m livekit_server_tpu_torch generate-keys
    python -m livekit_server_tpu_torch create-join-token --room r --identity i
    python -m livekit_server_tpu_torch bus [--host H --port P --token T]
    python -m livekit_server_tpu_torch list-nodes --config cluster.yaml
    python -m livekit_server_tpu_torch drain --config cluster.yaml --node ID
    python -m livekit_server_tpu_torch ports

Port of the JAX package's cli.py. `serve` runs the media plane on
`--device` ("cuda" by default, which needs a card; "cpu" runs the plain
PyTorch path) and needs aiohttp for its HTTP/WebSocket front. Every
config starts from `config.port_overlay()`, which turns off the
subsystems the port does not carry yet; a YAML file or flag that turns
one back on is refused with a ConfigError. The plane supervisor, the
integrity audit and the overload governor are ported and run on by
default, as in the reference, and so do the migration and fleet planes
once `kv.kind: tcp` points the node at a bus. `--dev` adds the
reference's `development: true`. `bus` runs the standalone BusServer
(loopback-only without `--token`); `list-nodes` and `drain` talk to the
cluster over it and build no media plane.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
import os
import signal
import sys

from livekit_server_tpu_torch.auth import AccessToken, VideoGrant
from livekit_server_tpu_torch.config import Config, generate_cli_flags, load_config
from livekit_server_tpu_torch.config.config import port_overlay
from livekit_server_tpu_torch.utils import ids
from livekit_server_tpu_torch.version import __version__


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="livekit-server-tpu-torch")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="command")

    serve = sub.add_parser("serve", help="run the server")
    serve.add_argument("--config", help="path to YAML config")
    serve.add_argument("--dev", action="store_true", help="development mode")
    serve.add_argument("--device", default="cuda",
                       help="torch device of the media plane (default cuda; "
                            "cpu runs the plain PyTorch path)")
    generate_cli_flags(serve)

    sub.add_parser("generate-keys", help="generate an API key/secret pair")

    tok = sub.add_parser("create-join-token", help="mint a join token")
    tok.add_argument("--room", required=True)
    tok.add_argument("--identity", required=True)
    tok.add_argument("--config", help="path to YAML config (for keys)")
    tok.add_argument("--key", help="API key (defaults to first config key)")

    bus = sub.add_parser(
        "bus", help="run the standalone message bus (the multi-node KV seat)"
    )
    bus.add_argument("--host", default="127.0.0.1",
                     help="bind address; a non-loopback bind requires --token")
    bus.add_argument("--port", type=int, default=7850)
    bus.add_argument("--token", default=os.environ.get("LIVEKIT_BUS_TOKEN", ""),
                     help="shared auth secret (env LIVEKIT_BUS_TOKEN); the bus "
                          "is the cluster control plane — never expose it bare")

    nodes = sub.add_parser("list-nodes", help="list cluster nodes")
    nodes.add_argument("--config", help="path to YAML config")

    drain = sub.add_parser(
        "drain",
        help="ask a node to migrate its rooms off and stop admitting "
             "(the live-migration plane's node drain)",
    )
    drain.add_argument("--config", help="path to YAML config (for the bus)")
    drain.add_argument("--node", required=True,
                       help="node id to drain (see list-nodes)")

    sub.add_parser("ports", help="print the ports the server uses")
    return p


def _cluster_config(args) -> Config:
    """The config `list-nodes` and `drain` read (for the bus)."""
    return load_config(
        yaml_path=args.config if args.config else None,
        base=None if args.config else {"development": True},
    )


def serve_config(args) -> Config:
    """The config `serve` runs: port_overlay(), then `development: true`
    under --dev, then the YAML file, env and flags."""
    base = port_overlay()
    if args.dev:
        base["development"] = True
    return load_config(yaml_path=args.config, cli_args=args, base=base)


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "generate-keys":
        print(f"API Key: {ids.new_api_key()}")
        print(f"API Secret: {ids.new_api_secret()}")
        return 0
    if args.command == "ports":
        cfg = Config()
        print(f"http/ws: {cfg.port}")
        print(f"rtc udp: {cfg.rtc.udp_port}")
        print(f"rtc tcp: {cfg.rtc.tcp_port}")
        print(f"port range: {cfg.rtc.port_range_start}-{cfg.rtc.port_range_end}")
        return 0
    if args.command == "bus":
        if args.host not in ("127.0.0.1", "localhost", "::1") and not args.token:
            print("refusing to bind the bus beyond loopback without --token",
                  flush=True)
            return 2

        async def run_bus():
            from livekit_server_tpu_torch.routing.tcpbus import BusServer

            srv = BusServer(token=args.token)
            await srv.start(args.host, args.port)
            print(f"bus listening on {args.host}:{srv.port}", flush=True)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            await stop.wait()
            srv.close()

        asyncio.run(run_bus())
        return 0
    if args.command == "list-nodes":
        cfg = _cluster_config(args)

        async def run():
            from livekit_server_tpu_torch.routing import LocalNode, create_router
            from livekit_server_tpu_torch.service.server import connect_bus

            # The reference lists through a whole server; the registry
            # needs only the router. Without the shared bus it falls back
            # to a private in-memory registry and lists this invocation.
            router = create_router(LocalNode(region=cfg.region), await connect_bus(cfg),
                                   lease_ttl=cfg.kv.lease_ttl_s,
                                   stats_interval=cfg.kv.stats_interval_s)
            await router.register_node()
            for n in await router.list_nodes():
                print(json.dumps(n.to_dict()))
            await router.unregister_node()

        asyncio.run(run())
        return 0
    if args.command == "drain":
        cfg = _cluster_config(args)

        async def run_drain():
            from livekit_server_tpu_torch.service.server import connect_bus

            bus = await connect_bus(cfg)
            if bus is None:
                print("drain needs a shared bus (kv.kind='tcp'); a "
                      "single-node server just stops", flush=True)
                return 2
            n = await bus.publish(f"node_migrate:{args.node}", {"kind": "drain"})
            if n == 0:
                print(f"node {args.node} is not listening (already gone?)",
                      flush=True)
                return 1
            print(f"drain requested on {args.node}", flush=True)
            return 0

        return asyncio.run(run_drain())
    if args.command == "create-join-token":
        cfg = load_config(
            yaml_path=args.config if args.config else None,
            base=None if args.config else {"development": True},
        )
        key = args.key or next(iter(cfg.keys))
        tok = AccessToken(key, cfg.keys[key])
        tok.identity = args.identity
        tok.grant = VideoGrant(room_join=True, room=args.room)
        print(tok.to_jwt())
        return 0
    if args.command == "serve":
        cfg = serve_config(args)
        if importlib.util.find_spec("aiohttp") is None:
            print("serve needs the aiohttp package for its HTTP/WebSocket "
                  "front, and it is not installed", file=sys.stderr, flush=True)
            return 3
        return asyncio.run(_serve(cfg, args.device))
    _build_parser().print_help()
    return 1


async def _serve(cfg: Config, device: str) -> int:
    from livekit_server_tpu_torch.service.server import connect_bus, create_server

    print(f"port overlay (subsystems not ported yet, turned off): "
          f"{json.dumps(port_overlay(), sort_keys=True)}", flush=True)
    server = create_server(cfg, bus=await connect_bus(cfg), device=device)
    await server.start()
    print(
        f"livekit-server-tpu-torch v{__version__} listening on "
        f"{cfg.bind_addresses}:{cfg.port} "
        f"(plane: {cfg.plane.rooms}r×{cfg.plane.tracks_per_room}t×"
        f"{cfg.plane.subs_per_room}s @ {cfg.plane.tick_ms}ms on "
        f"{server.room_manager.runtime.device})",
        flush=True,
    )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    print("shutting down...", flush=True)
    await server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
