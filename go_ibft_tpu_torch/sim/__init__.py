"""Cluster-scale lock-step simulation (the port of the JAX package's
``sim`` package).

``ClusterSim`` mounts N IBFT engines on one
:class:`~go_ibft_tpu_torch.net.ici.IciLockstepTransport` hub and steps them
in lock-step ticks; ``LoopbackClusterSim`` is the matched loopback baseline
(the tests' gossip shape) used as the chain oracle and the bench
comparison point.  ``ChaosMask`` fuses the chaos plane in as seeded tensor
masks on the collective schedule; ``AdversaryMix`` mounts scripted
Byzantine strategies on the same seeded schedule, and ``InvariantMonitor``
checks the safety/liveness properties the whole stack promises.
``run_fleet`` (:mod:`.fleet`) leaves the process: N real validator
processes over real sockets under a seeded client flood.
"""

from .adversary import (
    AdversaryEngine,
    AdversaryMix,
    CommitWithholder,
    EquivocatingProposer,
    RoundChangeSpammer,
    StaleHeightReplayer,
    STRATEGIES,
    TreePoisoner,
    cluster_replay_line,
    max_adversaries,
    parse_replay_line,
)
from .backend import SimBackend, sim_address, sim_block, sim_hash
from .chaos import ChaosMask, WAN_PRESETS, wan_mask, wan_regions
from .cluster import (
    ClusterResult,
    ClusterSim,
    LoopbackClusterSim,
    run_matched_pair,
)
from .fleet import (
    ConnectionFleet,
    FleetResult,
    FleetSpec,
    alloc_ports,
    build_fleet_configs,
    run_fleet,
)
from .invariants import InvariantMonitor, Violation

__all__ = [
    "AdversaryEngine",
    "AdversaryMix",
    "ChaosMask",
    "ClusterResult",
    "ClusterSim",
    "ConnectionFleet",
    "FleetResult",
    "FleetSpec",
    "CommitWithholder",
    "EquivocatingProposer",
    "InvariantMonitor",
    "LoopbackClusterSim",
    "RoundChangeSpammer",
    "STRATEGIES",
    "SimBackend",
    "StaleHeightReplayer",
    "TreePoisoner",
    "Violation",
    "WAN_PRESETS",
    "alloc_ports",
    "build_fleet_configs",
    "cluster_replay_line",
    "max_adversaries",
    "parse_replay_line",
    "run_fleet",
    "run_matched_pair",
    "sim_address",
    "sim_block",
    "sim_hash",
    "wan_mask",
    "wan_regions",
]
