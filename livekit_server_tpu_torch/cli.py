"""CLI entry point.

Reference parity: cmd/server/main.go (startServer :250-304, getConfig
:191) and commands.go (generate-keys, create-join-token, ports). Flags are
generated from the config schema exactly like the reference's
GenerateCLIFlags (main.go:126).

Usage:
    python -m livekit_server_tpu_torch serve --dev [--device cpu]
    python -m livekit_server_tpu_torch serve --config livekit.yaml
    python -m livekit_server_tpu_torch generate-keys
    python -m livekit_server_tpu_torch create-join-token --room r --identity i
    python -m livekit_server_tpu_torch ports

Port of the JAX package's cli.py. `serve` runs the media plane on
`--device` ("cuda" by default, which needs a card; "cpu" runs the plain
PyTorch path) and needs aiohttp for its HTTP/WebSocket front. Every
config starts from `config.port_overlay()`, which turns off the
subsystems the port does not carry yet; a YAML file or flag that turns
one back on is refused with a ConfigError. The plane supervisor, the
integrity audit and the overload governor are ported and run on by
default, as in the reference. `--dev` adds the reference's
`development: true`. The multi-node commands (bus, list-nodes, drain)
wait for the multi-node bus (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import asyncio
import importlib.util
import json
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

    sub.add_parser("ports", help="print the ports the server uses")
    return p


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
    from livekit_server_tpu_torch.service.server import create_server

    print(f"port overlay (subsystems not ported yet, turned off): "
          f"{json.dumps(port_overlay(), sort_keys=True)}", flush=True)
    server = create_server(cfg, device=device)
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
