"""The evidence helpers' historical location (a copy of the JAX package's
``bench/evidence.py``): a re-export of
:mod:`go_ibft_tpu_torch.obs.evidence`'s late card capture."""

from ..obs.evidence import EVIDENCE_PATH, reprobe_and_capture

__all__ = ["EVIDENCE_PATH", "reprobe_and_capture"]
