"""Configuration system.

Reference parity: pkg/config/config.go:57-946 — YAML config + env overrides
+ CLI flags *generated from the config schema by reflection*
(config.GenerateCLIFlags, cmd/server/main.go:126-135), strict unknown-key
checking, dev-mode defaults.
"""

from livekit_server_tpu_torch.config.config import (
    AudioConfig,
    BWEConfig,
    Config,
    ConfigError,
    LimitsConfig,
    NodeSelectorConfig,
    PlaneConfig,
    RegionConfig,
    RoomConfig,
    RTCConfig,
    TwinConfig,
    generate_cli_flags,
    load_config,
)

__all__ = [
    "AudioConfig",
    "BWEConfig",
    "Config",
    "ConfigError",
    "LimitsConfig",
    "NodeSelectorConfig",
    "PlaneConfig",
    "RegionConfig",
    "RoomConfig",
    "RTCConfig",
    "TwinConfig",
    "generate_cli_flags",
    "load_config",
]
