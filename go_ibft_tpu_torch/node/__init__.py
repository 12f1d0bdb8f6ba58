"""The validator process's ported parts (the port of the JAX package's
``node``).

Only the proof API is ported: :class:`ProofApiServer`, the read plane's
HTTP transport (``GET /head``, ``/proof`` and ``/checkpoints``).  The
validator process itself (``node.py``, ``config.py``, ``__main__.py``)
waits for the socket gossip transport (``net/grpc_transport.py``).
"""

from .proof_api import ProofApiServer

__all__ = ["ProofApiServer"]
