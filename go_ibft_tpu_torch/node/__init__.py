"""The deployable validator process (the port of the JAX package's
``node``).

``python -m go_ibft_tpu_torch.node --config node.toml`` boots one
validator: socket-native consensus gossip (:mod:`go_ibft_tpu_torch.net`'s
``GrpcTransport``), WAL-backed chain (:mod:`go_ibft_tpu_torch.chain`),
QoS-tiered verification on the card (:mod:`go_ibft_tpu_torch.sched`), the
proof-API wire transport (:mod:`go_ibft_tpu_torch.serve` over
:mod:`.proof_api`), telemetry with the liveness/readiness split
(:mod:`go_ibft_tpu_torch.obs.httpd`), and graceful SIGTERM drain.
"""

from .config import NodeConfig, NodeConfigError, load_config, parse_toml_subset
from .node import ValidatorNode, build_block_fn
from .proof_api import ProofApiServer

__all__ = [
    "NodeConfig",
    "NodeConfigError",
    "ProofApiServer",
    "ValidatorNode",
    "build_block_fn",
    "load_config",
    "parse_toml_subset",
]
