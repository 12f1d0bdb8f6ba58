"""Node configuration: the ``node.toml`` schema + a dependency-free loader
(the port of the JAX package's ``node/config.py``).

``python -m go_ibft_tpu_torch.node --config node.toml`` is the deployable
validator process; this module defines what it reads.  The loader is the
JAX package's, which had no stdlib ``tomllib``: it implements the TOML
subset the schema needs — ``[section]`` / ``[section.sub]`` tables,
``key = value`` pairs with string / int / float / bool / flat-list
values, quoted keys (validator addresses are hex strings), and ``#``
comments.  Anything outside that subset is a :class:`NodeConfigError`,
never a silent misparse.

Schema (all sections optional except ``[node]`` + ``[validators]``)::

    [node]
    id = 0                          # ordinal, used in logs/evidence
    key_seed = "fleet-node-0"       # deterministic key seed (or "hex:..")
    data_dir = "/var/lib/go-ibft/0" # WAL + trace output live here
    heights = 0                     # stop after height N; 0 = run forever

    [consensus]
    listen = "127.0.0.1:7000"       # gRPC consensus gossip bind address
    base_round_timeout_s = 10.0
    reconnect_after = 2             # peer sends that trigger a reconnect

    [consensus.peers]               # name -> target, everyone but self
    node1 = "127.0.0.1:7001"

    [validators]                    # address hex -> voting power
    "ab12..." = 1

    [proof_api]
    listen = "127.0.0.1:8440"       # "" disables the proof API
    max_connections = 1024          # concurrent sockets; excess get 503
    max_request_bytes = 8192        # request line + headers bound
    header_timeout_s = 5.0          # slowloris cutoff (partial request)
    idle_timeout_s = 30.0           # keep-alive idle cutoff
    workers = 2                     # proof-build worker threads
    max_proof_heights = 512         # per-request range clamp

    [telemetry]
    listen = "127.0.0.1:0"          # "" disables /metrics,/healthz,/readyz
    wedged_after_s = 0.0            # 0 = runner default

    [sched]
    enabled = true                  # consensus/read QoS tiers
    route = "device"                # "host" | "auto" | "device"; non-host
                                    # routes warm the kernels at boot
    device = ""                     # "" = the card; "cpu" only when asked
                                    # for (also "cuda:N")

    [trace]
    enabled = true                  # flight recorder; exported on drain
    ring = 262144

See docs/DEPLOYMENT.md for the operator story.

Differences from the JAX file: ``[sched] route`` defaults to ``"device"``
(the port's entry points run on the card unless the caller asks for the
CPU; the JAX package kept ``"host"`` so that no first XLA compile stalled
a live round, and here the node builds and launches its kernels before
``/readyz`` instead); the new ``[sched] device`` key says where the
device route runs (``""``: the card, ``"cpu"``: asked for), and
``route = "host"`` stays the explicit host choice.  Every other text of
``to_toml()`` and ``validate()`` is the JAX package's.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

__all__ = [
    "NodeConfig",
    "NodeConfigError",
    "load_config",
    "parse_toml_subset",
]


class NodeConfigError(ValueError):
    """Raised on malformed/out-of-subset TOML or invalid settings."""


# ---------------------------------------------------------------------------
# the TOML-subset parser
# ---------------------------------------------------------------------------

_DEVICE_RE = re.compile(r"^(|cpu|cuda(:\d+)?)$")
_SECTION_RE = re.compile(r"^\[([A-Za-z0-9_.\-]+)\]$")
_BARE_KEY_RE = re.compile(r"^[A-Za-z0-9_\-]+$")


def _strip_comment(line: str) -> str:
    """Cut a ``#`` comment (quote-aware: a ``#`` inside a string stays)."""
    out = []
    in_str = False
    for ch in line:
        if ch == '"':
            in_str = not in_str
        elif ch == "#" and not in_str:
            break
        out.append(ch)
    return "".join(out).strip()


def _parse_scalar(raw: str, where: str):
    raw = raw.strip()
    if not raw:
        raise NodeConfigError(f"{where}: empty value")
    if raw.startswith('"'):
        if not (raw.endswith('"') and len(raw) >= 2):
            raise NodeConfigError(f"{where}: unterminated string {raw!r}")
        body = raw[1:-1]
        if '"' in body:
            raise NodeConfigError(f"{where}: bad string {raw!r}")
        return body
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw, 10)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        raise NodeConfigError(
            f"{where}: unsupported value {raw!r} (subset: string/int/"
            f"float/bool/list)"
        ) from None


def _parse_value(raw: str, where: str):
    raw = raw.strip()
    if raw.startswith("["):
        if not raw.endswith("]"):
            raise NodeConfigError(f"{where}: unterminated list {raw!r}")
        body = raw[1:-1].strip()
        if not body:
            return []
        return [_parse_scalar(item, where) for item in body.split(",")]
    return _parse_scalar(raw, where)


def _parse_key(raw: str, where: str) -> str:
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    if _BARE_KEY_RE.match(raw):
        return raw
    raise NodeConfigError(f"{where}: bad key {raw!r}")


def parse_toml_subset(text: str) -> Dict[str, dict]:
    """Parse the documented TOML subset into nested dicts.

    Dotted section headers nest (``[consensus.peers]`` lands under
    ``out["consensus"]["peers"]``); key/value pairs before any header
    land at top level.  Raises :class:`NodeConfigError` with the line
    number on anything outside the subset.
    """
    out: Dict[str, dict] = {}
    current = out
    for lineno, raw_line in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw_line)
        if not line:
            continue
        where = f"line {lineno}"
        m = _SECTION_RE.match(line)
        if m:
            current = out
            for part in m.group(1).split("."):
                if not part:
                    raise NodeConfigError(f"{where}: bad section {line!r}")
                nxt = current.setdefault(part, {})
                if not isinstance(nxt, dict):
                    raise NodeConfigError(
                        f"{where}: section {part!r} collides with a value"
                    )
                current = nxt
            continue
        if "=" not in line:
            raise NodeConfigError(f"{where}: expected key = value, got {line!r}")
        key_raw, _, value_raw = line.partition("=")
        key = _parse_key(key_raw, where)
        if key in current:
            raise NodeConfigError(f"{where}: duplicate key {key!r}")
        current[key] = _parse_value(value_raw, where)
    return out


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------


def _toml_str(value: str) -> str:
    if '"' in value or "\n" in value:
        raise NodeConfigError(f"unencodable string {value!r}")
    return f'"{value}"'


def _toml_value(value: Union[str, int, float, bool]) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    return _toml_str(value)


@dataclass
class ConsensusConfig:
    listen: str = "127.0.0.1:0"
    peers: Dict[str, str] = field(default_factory=dict)
    base_round_timeout_s: float = 10.0
    reconnect_after: int = 2


@dataclass
class ProofApiConfig:
    listen: str = ""  # "" = disabled
    max_connections: int = 1024
    max_request_bytes: int = 8192
    header_timeout_s: float = 5.0
    idle_timeout_s: float = 30.0
    workers: int = 2
    max_proof_heights: int = 512


@dataclass
class TelemetryConfig:
    listen: str = ""  # "" = disabled
    wedged_after_s: float = 0.0  # 0 = runner default


@dataclass
class TraceConfig:
    enabled: bool = True
    ring: int = 1 << 18


def _proof_api_from(section: dict) -> ProofApiConfig:
    unknown = set(section) - {
        "listen",
        "max_connections",
        "max_request_bytes",
        "header_timeout_s",
        "idle_timeout_s",
        "workers",
        "max_proof_heights",
    }
    if unknown:
        raise NodeConfigError(f"[proof_api] unknown key(s): {sorted(unknown)}")
    return ProofApiConfig(
        listen=str(section.get("listen", "")),
        max_connections=int(section.get("max_connections", 1024)),
        max_request_bytes=int(section.get("max_request_bytes", 8192)),
        header_timeout_s=float(section.get("header_timeout_s", 5.0)),
        idle_timeout_s=float(section.get("idle_timeout_s", 30.0)),
        workers=int(section.get("workers", 2)),
        max_proof_heights=int(section.get("max_proof_heights", 512)),
    )


@dataclass
class NodeConfig:
    node_id: int
    key_seed: str
    data_dir: str
    validators: Dict[str, int]  # address hex -> power
    heights: int = 0  # 0 = run forever
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    proof_api: ProofApiConfig = field(default_factory=ProofApiConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    sched_enabled: bool = True
    # The card by default: the node builds and launches its kernels at
    # boot, before /readyz, so no first launch stalls a live round.
    # "host" is the explicit host choice.
    sched_route: str = "device"
    # Where the device route runs: "" = the card, "cpu" when asked for.
    sched_device: str = ""

    @property
    def torch_device(self) -> Optional[str]:
        """``[sched] device`` as a torch device string (``None``: the card)."""
        return self.sched_device or None

    @property
    def key_seed_bytes(self) -> bytes:
        """Seed bytes for :meth:`PrivateKey.from_seed` — ``hex:`` prefix
        for raw bytes, utf-8 otherwise (the fleet harness uses plain
        strings; operators with real key material use hex)."""
        if self.key_seed.startswith("hex:"):
            return bytes.fromhex(self.key_seed[4:])
        return self.key_seed.encode("utf-8")

    def validator_powers(self) -> Dict[bytes, int]:
        return {
            bytes.fromhex(addr): power
            for addr, power in self.validators.items()
        }

    def validate(self) -> "NodeConfig":
        if not self.key_seed:
            raise NodeConfigError("[node] key_seed is required")
        if not self.data_dir:
            raise NodeConfigError("[node] data_dir is required")
        if not self.validators:
            raise NodeConfigError("[validators] must name at least one")
        for addr, power in self.validators.items():
            try:
                raw = bytes.fromhex(addr)
            except ValueError:
                raise NodeConfigError(
                    f"[validators] {addr!r} is not hex"
                ) from None
            if not raw:
                raise NodeConfigError("[validators] empty address")
            if not isinstance(power, int) or power <= 0:
                raise NodeConfigError(
                    f"[validators] {addr}: power must be a positive int"
                )
        for name, listen in (
            ("[consensus] listen", self.consensus.listen),
            ("[proof_api] listen", self.proof_api.listen),
            ("[telemetry] listen", self.telemetry.listen),
        ):
            if listen and ":" not in listen:
                raise NodeConfigError(f"{name}: expected host:port")
        if self.consensus.base_round_timeout_s <= 0:
            raise NodeConfigError("[consensus] base_round_timeout_s must be > 0")
        if self.proof_api.max_connections < 1:
            raise NodeConfigError("[proof_api] max_connections must be >= 1")
        if self.proof_api.max_request_bytes < 64:
            raise NodeConfigError("[proof_api] max_request_bytes must be >= 64")
        if self.heights < 0:
            raise NodeConfigError("[node] heights must be >= 0")
        if self.sched_route not in ("host", "auto", "device"):
            raise NodeConfigError(
                f"[sched] route {self.sched_route!r}: expected "
                f"host | auto | device"
            )
        if not _DEVICE_RE.match(self.sched_device):
            raise NodeConfigError(
                f"[sched] device {self.sched_device!r}: expected "
                f'"" (the card) | cpu | cuda:N'
            )
        return self

    # -- wire ------------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, dict]) -> "NodeConfig":
        known = {
            "node",
            "consensus",
            "validators",
            "proof_api",
            "telemetry",
            "sched",
            "trace",
        }
        unknown = set(data) - known
        if unknown:
            # Typos must fail loud: a misspelled section silently running
            # defaults is how a node boots without its WAL directory.
            raise NodeConfigError(f"unknown section(s): {sorted(unknown)}")
        node = data.get("node", {})
        consensus = dict(data.get("consensus", {}))
        peers = consensus.pop("peers", {})
        cfg = cls(
            node_id=int(node.get("id", 0)),
            key_seed=str(node.get("key_seed", "")),
            data_dir=str(node.get("data_dir", "")),
            heights=int(node.get("heights", 0)),
            validators={
                str(addr): power
                for addr, power in data.get("validators", {}).items()
            },
            consensus=ConsensusConfig(
                listen=str(consensus.get("listen", "127.0.0.1:0")),
                peers={str(k): str(v) for k, v in peers.items()},
                base_round_timeout_s=float(
                    consensus.get("base_round_timeout_s", 10.0)
                ),
                reconnect_after=int(consensus.get("reconnect_after", 2)),
            ),
            proof_api=_proof_api_from(data.get("proof_api", {})),
            telemetry=TelemetryConfig(
                listen=str(data.get("telemetry", {}).get("listen", "")),
                wedged_after_s=float(
                    data.get("telemetry", {}).get("wedged_after_s", 0.0)
                ),
            ),
            trace=TraceConfig(
                enabled=bool(data.get("trace", {}).get("enabled", True)),
                ring=int(data.get("trace", {}).get("ring", 1 << 18)),
            ),
            sched_enabled=bool(data.get("sched", {}).get("enabled", True)),
            sched_route=str(data.get("sched", {}).get("route", "device")),
            sched_device=str(data.get("sched", {}).get("device", "")),
        )
        return cfg.validate()

    def to_toml(self) -> str:
        """Render back to the documented schema (the fleet harness writes
        every node's config through this — round-trip pinned in tests)."""
        lines = [
            "[node]",
            f"id = {self.node_id}",
            f"key_seed = {_toml_str(self.key_seed)}",
            f"data_dir = {_toml_str(self.data_dir)}",
            f"heights = {self.heights}",
            "",
            "[consensus]",
            f"listen = {_toml_str(self.consensus.listen)}",
            f"base_round_timeout_s = {_toml_value(self.consensus.base_round_timeout_s)}",
            f"reconnect_after = {self.consensus.reconnect_after}",
            "",
            "[consensus.peers]",
        ]
        for name, target in sorted(self.consensus.peers.items()):
            lines.append(f"{name} = {_toml_str(target)}")
        lines += ["", "[validators]"]
        for addr, power in sorted(self.validators.items()):
            lines.append(f'"{addr}" = {power}')
        p = self.proof_api
        lines += [
            "",
            "[proof_api]",
            f"listen = {_toml_str(p.listen)}",
            f"max_connections = {p.max_connections}",
            f"max_request_bytes = {p.max_request_bytes}",
            f"header_timeout_s = {_toml_value(p.header_timeout_s)}",
            f"idle_timeout_s = {_toml_value(p.idle_timeout_s)}",
            f"workers = {p.workers}",
            f"max_proof_heights = {p.max_proof_heights}",
            "",
            "[telemetry]",
            f"listen = {_toml_str(self.telemetry.listen)}",
            f"wedged_after_s = {_toml_value(self.telemetry.wedged_after_s)}",
            "",
            "[sched]",
            f"enabled = {_toml_value(self.sched_enabled)}",
            f"route = {_toml_str(self.sched_route)}",
            f"device = {_toml_str(self.sched_device)}",
            "",
            "[trace]",
            f"enabled = {_toml_value(self.trace.enabled)}",
            f"ring = {self.trace.ring}",
        ]
        return "\n".join(lines) + "\n"


def load_config(path: Union[str, os.PathLike]) -> NodeConfig:
    """Read + parse + validate a ``node.toml``."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    try:
        return NodeConfig.from_dict(parse_toml_subset(text))
    except NodeConfigError as err:
        raise NodeConfigError(f"{path}: {err}") from None
