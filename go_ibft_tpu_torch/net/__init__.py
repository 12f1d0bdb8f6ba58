"""Communication backends (the port of the JAX package's ``net`` package).

* :class:`GrpcTransport` — asyncio gRPC fire-and-forget multicast between
  validator processes, the validator node's gossip (``grpc`` is imported
  when a transport starts, so this package loads without it);
* :class:`IciLockstepTransport` — the lock-step simulation transport: N
  validators on one hub, "multicast" is one gather of fixed-size message
  tensors split over the hub's devices, consensus rounds become lock-step
  ticks (:func:`build_tick_program`; :class:`TickVerdictVerifier` serves
  the engines' sender checks from a tick's verdicts).
* :class:`AggregationTreeGossip` — aggregate-signature COMMIT
  dissemination: seals merge up a fan-in tree as partial aggregates and
  ONE quorum certificate broadcasts down, so per-node COMMIT wire cost
  stops scaling with committee size.  Given a
  :class:`~go_ibft_tpu_torch.verify.aggregate.G2MergeTree`, every sweep
  level's slot merges are one merge-kernel launch.
"""

from .aggtree import AggregationTreeGossip
from .grpc_transport import GrpcTransport
from .ici import IciLockstepTransport, TickVerdictVerifier, build_tick_program

__all__ = [
    "AggregationTreeGossip",
    "GrpcTransport",
    "IciLockstepTransport",
    "TickVerdictVerifier",
    "build_tick_program",
]
