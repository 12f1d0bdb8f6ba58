"""Wire schema and helpers (copies of ``go_ibft_tpu.messages`` modules)."""

from .helpers import CommittedSeal, extract_committed_seal
from .wire import IbftMessage, MessageType, Proposal, View

__all__ = [
    "CommittedSeal",
    "IbftMessage",
    "MessageType",
    "Proposal",
    "View",
    "extract_committed_seal",
]
