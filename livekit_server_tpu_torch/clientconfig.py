"""Per-client quirk configuration (device/SDK workarounds).

Reference parity: pkg/clientconfiguration/ — a rule list matched against
the client's ClientInfo at join (conf.go GetConfiguration); matching rules
yield a ClientConfiguration (disabled codecs, resume on/off) that rides
the JoinResponse and gates server behavior (match.go's script matcher,
staticconfiguration.go's shipped rules).

The reference evaluates tengo script expressions; here a rule is declara-
tive data — a list of OR-groups of field→value(s) AND-matches — which
covers every shipped rule without an embedded interpreter (no arbitrary
code evaluation on a hot join path).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ClientConfiguration:
    """livekit.ClientConfiguration subset the server acts on."""

    resume_connection: str = ""              # "" | "enabled" | "disabled"
    disabled_codecs: list[str] = field(default_factory=list)          # both ways
    disabled_publish_codecs: list[str] = field(default_factory=list)  # publish only

    def to_dict(self) -> dict:
        return {
            "resume_connection": self.resume_connection,
            "disabled_codecs": {
                "codecs": [{"mime": m} for m in self.disabled_codecs],
                "publish": [{"mime": m} for m in self.disabled_publish_codecs],
            },
        }


@dataclass
class ConfigurationItem:
    """One rule: `match` is a list of AND-dicts (field → value or list of
    values, lowercase); the rule fires if ANY dict fully matches."""

    match: list[dict]
    configuration: ClientConfiguration
    merge: bool = False


# staticconfiguration.go StaticConfigurations (the active rule set):
# H.264 publish is broken on this Xiaomi model and on Firefox
# (desktop Linux + Android).
STATIC_CONFIGURATIONS = [
    ConfigurationItem(
        match=[
            {"device_model": "xiaomi 2201117ti", "os": "android"},
            {"browser": ["firefox", "firefox mobile"], "os": ["linux", "android"]},
        ],
        configuration=ClientConfiguration(
            disabled_publish_codecs=["video/h264"]
        ),
    ),
]


def _norm(v) -> str:
    return str(v).strip().lower()


def _and_match(rule: dict, info: dict) -> bool:
    for key, want in rule.items():
        got = _norm(info.get(key, ""))
        if isinstance(want, (list, tuple, set)):
            if got not in {_norm(w) for w in want}:
                return False
        elif got != _norm(want):
            return False
    return True


class ClientConfigurationManager:
    """conf.go StaticClientConfigurationManager."""

    def __init__(self, items: list[ConfigurationItem] | None = None):
        self.items = STATIC_CONFIGURATIONS if items is None else items

    def get_configuration(self, client_info: dict | None) -> ClientConfiguration | None:
        if not client_info:
            return None
        merged: ClientConfiguration | None = None
        for item in self.items:
            if not any(_and_match(rule, client_info) for rule in item.match):
                continue
            if not item.merge:
                return item.configuration
            if merged is None:
                merged = ClientConfiguration()
            if item.configuration.resume_connection:
                merged.resume_connection = item.configuration.resume_connection
            merged.disabled_codecs += item.configuration.disabled_codecs
            merged.disabled_publish_codecs += item.configuration.disabled_publish_codecs
        return merged
