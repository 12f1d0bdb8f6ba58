"""Communication backends (the port of the JAX package's ``net`` package).

* :class:`AggregationTreeGossip` — aggregate-signature COMMIT
  dissemination: seals merge up a fan-in tree as partial aggregates and
  ONE quorum certificate broadcasts down, so per-node COMMIT wire cost
  stops scaling with committee size.  Given a
  :class:`~go_ibft_tpu_torch.verify.aggregate.G2MergeTree`, every sweep
  level's slot merges are one merge-kernel launch.

The JAX package's ``GrpcTransport`` and ``IciLockstepTransport`` wait for
their slices (serving, and the cluster simulation).
"""

from .aggtree import AggregationTreeGossip

__all__ = ["AggregationTreeGossip"]
