"""Finality proofs: the light-client payload the serve plane assembles (the
port of the JAX package's ``serve/proof.py``: the same wire bytes).

"Practical Light Clients for Committee-Based Blockchains" (PAPERS.md,
2410.03347) reduces catching a light client up to a committee chain to
three ingredients per height: the header, the commit-quorum evidence
(per-validator seals, or — "Performance of EdDSA and BLS Signatures in
Committee-Based Consensus", 2302.00418 — one O(1) aggregate quorum
certificate), and the validator-set changes connecting the client's
trusted checkpoint to the target height.  This module is those three
ingredients as data:

* :class:`ProofEntry` — one height's header (the consensus ``Proposal``)
  plus exactly ONE evidence form: a seal list or an
  :class:`~go_ibft_tpu_torch.crypto.quorum_cert.AggregateQuorumCertificate`
  (both at once is the evidence-smuggling shape the sync client rejects,
  and proof verification rejects it too — see ``serve/server.py``);
* :class:`SetDiff` — the validator-set rotation taking effect AT a
  height, as ``added`` (address -> power, covering power changes) and
  ``removed`` deltas against the previous height's set;
* :class:`FinalityProof` — a contiguous range of entries anchored at the
  client's trusted ``checkpoint_height``, with the ascending diff chain
  for every rotation inside the range.

:class:`ProofBuilder` assembles these from a
:class:`~go_ibft_tpu_torch.chain.sync.SyncSource` (``ChainRunner`` implements
it) and the per-height validator-set snapshot seam
(``validators_for_height`` — the same callable every verifier takes).
Because IBFT finality is irreversible, a built entry never changes; the
height-range cache (``serve/cache.py``) exploits exactly that.

Trust posture (docs/SERVING.md): the client trusts its checkpoint — a
``(height, validator powers for height+1)`` pair — and everything else
is re-derived: each height's quorum is re-checked against the set
obtained by applying the served diffs hop by hop from the checkpoint, so
a proof spliced across a substantive rotation with the STALE set fails
quorum at the first post-rotation height.  The walk alone catches
omission and staleness; FABRICATION is closed by next-set content
commitments (``go_ibft_tpu_torch/lightsync/commitment.py``): a
producing embedder embeds the NEXT height's set root inside the signed
proposal bytes, and :func:`walk_sets` checks every hop's derived set
against the root the PREVIOUS height's quorum sealed — a server-invented
rotation (or an omitted one) now fails at the commitment check, no
old-quorum signature over the diff required.  Enforcement is opt-in per
verifier (``require_commitments=True``) because commitment-free chains
predate the scheme; when enforced, a hop without a commitment is itself
an error.  The remaining epoch-boundary assumptions are documented in
docs/SERVING.md's trust assumptions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ..chain.sync import SyncSource
from ..chain.wal import FinalizedBlock
from ..lightsync.commitment import extract_next_set, set_root
from ..messages.helpers import CommittedSeal
from ..messages.wire import Proposal

__all__ = [
    "FinalityProof",
    "ProofBuilder",
    "ProofEntry",
    "ProofError",
    "SetDiff",
    "diff_chain",
    "walk_sets",
]

PROOF_WIRE_VERSION = 1


class ProofError(ValueError):
    """A finality proof failed structural or cryptographic verification
    (or could not be built for the requested range)."""


@dataclass
class SetDiff:
    """Validator-set rotation taking effect AT ``height``.

    ``added`` maps address -> voting power and doubles as the
    power-change form (an address present in both the old set and
    ``added`` takes the new power); ``removed`` lists addresses leaving
    the set.  Applying the diff to the set of ``height - 1`` yields the
    set of ``height``.
    """

    height: int
    added: Dict[bytes, int] = field(default_factory=dict)
    removed: Tuple[bytes, ...] = ()

    def apply(self, powers: Mapping[bytes, int]) -> Dict[bytes, int]:
        out = dict(powers)
        for addr in self.removed:
            out.pop(addr, None)
        out.update(self.added)
        return out

    # -- wire ------------------------------------------------------------

    def to_wire(self) -> dict:
        return {
            "height": self.height,
            "added": {a.hex(): int(p) for a, p in self.added.items()},
            "removed": [a.hex() for a in self.removed],
        }

    @classmethod
    def from_wire(cls, rec: dict) -> "SetDiff":
        return cls(
            height=int(rec["height"]),
            added={
                bytes.fromhex(a): int(p) for a, p in rec.get("added", {}).items()
            },
            removed=tuple(bytes.fromhex(a) for a in rec.get("removed", ())),
        )


@dataclass
class ProofEntry:
    """One finalized height: header + commit-quorum evidence.

    Mirrors :class:`~go_ibft_tpu_torch.chain.wal.FinalizedBlock` (``seals`` and
    ``cert`` are mutually exclusive — the WAL writes them that way and
    verification REJECTS an entry carrying both, the same smuggling gate
    the sync client enforces).
    """

    height: int
    proposal: Proposal
    seals: List[CommittedSeal] = field(default_factory=list)
    cert: Optional[object] = None  # AggregateQuorumCertificate

    @classmethod
    def from_block(cls, block: FinalizedBlock) -> "ProofEntry":
        return cls(
            height=block.height,
            proposal=block.proposal,
            seals=list(block.seals),
            cert=block.cert,
        )

    # -- wire (the WAL's hex-through-the-codec record shape) -------------

    def to_wire(self) -> dict:
        rec = {
            "height": self.height,
            "proposal": self.proposal.encode().hex(),
        }
        if self.cert is not None:
            rec["cert"] = self.cert.encode().hex()
        rec["seals"] = [
            [s.signer.hex(), s.signature.hex()] for s in self.seals
        ]
        return rec

    @classmethod
    def from_wire(cls, rec: dict) -> "ProofEntry":
        cert_hex = rec.get("cert")
        cert = None
        if cert_hex is not None:
            from ..crypto.quorum_cert import AggregateQuorumCertificate

            cert = AggregateQuorumCertificate.decode(bytes.fromhex(cert_hex))
        return cls(
            height=int(rec["height"]),
            proposal=Proposal.decode(bytes.fromhex(rec["proposal"])),
            seals=[
                CommittedSeal(
                    signer=bytes.fromhex(signer),
                    signature=bytes.fromhex(signature),
                )
                for signer, signature in rec.get("seals", ())
            ],
            cert=cert,
        )


@dataclass
class FinalityProof:
    """A contiguous finality-proof range anchored at a trusted checkpoint.

    ``entries`` cover heights ``checkpoint_height + 1 .. target``
    (ascending, contiguous); ``diffs`` is the ascending rotation chain
    for heights in ``(checkpoint_height + 1, target]`` — the FIRST proven
    height carries no diff because the client's trusted powers already
    apply to it.
    """

    checkpoint_height: int
    entries: List[ProofEntry] = field(default_factory=list)
    diffs: List[SetDiff] = field(default_factory=list)

    @property
    def target(self) -> int:
        return self.entries[-1].height if self.entries else self.checkpoint_height

    def to_wire(self) -> dict:
        return {
            "version": PROOF_WIRE_VERSION,
            "checkpoint": self.checkpoint_height,
            "entries": [e.to_wire() for e in self.entries],
            "diffs": [d.to_wire() for d in self.diffs],
        }

    @classmethod
    def from_wire(cls, rec: dict) -> "FinalityProof":
        version = rec.get("version") if isinstance(rec, dict) else None
        if version != PROOF_WIRE_VERSION:
            raise ProofError(f"unknown finality-proof version {version!r}")
        # Wire data is untrusted: every decode failure (missing key, bad
        # hex, non-numeric height, a corrupt nested proposal/cert blob)
        # surfaces as the documented ProofError contract, never a bare
        # KeyError/ValueError escaping the client's `except ProofError`.
        try:
            return cls(
                checkpoint_height=int(rec["checkpoint"]),
                entries=[
                    ProofEntry.from_wire(e) for e in rec.get("entries", ())
                ],
                diffs=[SetDiff.from_wire(d) for d in rec.get("diffs", ())],
            )
        except ProofError:
            raise
        except Exception as err:  # noqa: BLE001 - malformed untrusted bytes
            raise ProofError(
                f"malformed finality-proof wire record: "
                f"{type(err).__name__}: {err}"
            ) from err


def diff_chain(
    validators_for_height: Callable[[int], Mapping[bytes, int]],
    start: int,
    end: int,
) -> List[SetDiff]:
    """Rotation diffs for every height in ``[start, end]`` vs its
    predecessor (``start`` itself diffs against ``start - 1`` so a
    rotation landing exactly on a cache-chunk boundary is never lost).
    Heights with an unchanged set contribute nothing."""
    diffs: List[SetDiff] = []
    prev = dict(validators_for_height(start - 1)) if start > 1 else None
    for h in range(start, end + 1):
        cur = dict(validators_for_height(h))
        if prev is not None and cur != prev:
            diffs.append(
                SetDiff(
                    height=h,
                    added={
                        a: p
                        for a, p in cur.items()
                        if prev.get(a) != p
                    },
                    removed=tuple(sorted(a for a in prev if a not in cur)),
                )
            )
        prev = cur
    return diffs


def _check_powers(powers: Mapping[bytes, int], height: int) -> None:
    """Voting-power sanity at every hop of the walk.

    ``calculate_quorum`` over a non-positive total would yield a quorum
    of <= 0, and a quorum of <= 0 is satisfiable by ZERO seals — a
    served diff carrying negative or zero powers could otherwise turn
    the quorum check into a no-op for every height after it (the
    ``core/validator_manager.py::VotingPowerError`` invariant, enforced
    here against attacker-supplied wire data)."""
    total = 0
    for addr, power in powers.items():
        if not isinstance(power, int) or power <= 0:
            raise ProofError(
                f"height {height}: validator {addr.hex()[:16]} has "
                f"non-positive voting power {power!r}"
            )
        total += power
    if total <= 0:
        raise ProofError(f"height {height}: total voting power {total} <= 0")


def walk_sets(
    trusted_powers: Mapping[bytes, int],
    proof: FinalityProof,
    *,
    require_commitments: bool = False,
) -> Dict[int, Mapping[bytes, int]]:
    """Structurally validate ``proof`` and derive each height's validator
    set by walking the diff chain from the trusted checkpoint powers.

    Raises :class:`ProofError` on: empty range, a first entry that is not
    ``checkpoint + 1``, non-contiguous entries, out-of-range / unordered
    / duplicate diffs, a diff claimed for the first proven height (the
    trusted powers already apply there — a server cannot substitute the
    anchor set), or any hop whose powers are not strictly positive ints
    (a non-positive total would make ``calculate_quorum`` vacuous).

    Next-set commitment enforcement: when height ``h-1``'s
    proposal carries a next-set commitment frame
    (``lightsync/commitment.py``), the set derived for ``h`` must match
    the committed root — a fabricated diff AND an omitted rotation both
    fail here, because the root was sealed by ``h-1``'s commit quorum
    inside the proposal bytes.  With ``require_commitments=True`` a hop
    whose predecessor carries NO commitment is rejected too (the posture
    for chains producing commitments end to end); the first proven
    height needs none — the trusted anchor powers apply there.
    Cryptographic checks are the verifier's (``serve/server.py``); this
    walk is pure dict arithmetic plus one keccak per set change.
    """
    if not proof.entries:
        raise ProofError("finality proof carries no heights")
    first = proof.checkpoint_height + 1
    if proof.entries[0].height != first:
        raise ProofError(
            f"proof starts at height {proof.entries[0].height}, "
            f"checkpoint {proof.checkpoint_height} requires {first}"
        )
    heights = [e.height for e in proof.entries]
    if heights != list(range(first, first + len(heights))):
        raise ProofError("proof entries are not a contiguous height range")
    last = heights[-1]
    prev_h = first
    diff_by_height: Dict[int, SetDiff] = {}
    for d in proof.diffs:
        if not (first < d.height <= last):
            raise ProofError(
                f"set diff at height {d.height} outside ({first}, {last}]"
            )
        if d.height <= prev_h and diff_by_height:
            raise ProofError("set-diff chain is not strictly ascending")
        if d.height in diff_by_height:
            raise ProofError(f"duplicate set diff for height {d.height}")
        diff_by_height[d.height] = d
        prev_h = d.height
    sets: Dict[int, Mapping[bytes, int]] = {}
    cur: Mapping[bytes, int] = dict(trusted_powers)
    if not cur:
        raise ProofError("trusted checkpoint powers are empty")
    _check_powers(cur, first)
    cur_root: Optional[bytes] = None  # set_root(cur), computed on demand
    prev_entry: Optional[ProofEntry] = None
    for entry in proof.entries:
        h = entry.height
        d = diff_by_height.get(h)
        if d is not None:
            cur = d.apply(cur)
            if not cur:
                raise ProofError(f"set diff at height {h} empties the set")
            _check_powers(cur, h)
            cur_root = None
        if prev_entry is not None:
            committed = extract_next_set(prev_entry.proposal.raw_proposal)
            if committed is None:
                if require_commitments:
                    raise ProofError(
                        f"height {h}: the height {h - 1} proposal carries "
                        "no next-set commitment (required by this client)"
                    )
            else:
                if cur_root is None:
                    cur_root = set_root(cur)
                if committed != cur_root:
                    raise ProofError(
                        f"height {h}: served validator set does not match "
                        f"the next-set root the height {h - 1} quorum "
                        "sealed (fabricated or omitted rotation)"
                    )
        sets[h] = cur
        prev_entry = entry
    return sets


class ProofBuilder:
    """Assembles finality proofs from a node's served chain.

    ``source`` is any :class:`~go_ibft_tpu_torch.chain.sync.SyncSource`
    (``ChainRunner`` serves its own chain through it);
    ``validators_for_height`` is the per-height snapshot seam the engine
    already uses everywhere.  The builder is pure assembly — it signs
    nothing and verifies nothing; the server's pre-serve self-check and
    the client's verification both run through ``serve/server.py``.
    """

    def __init__(
        self,
        source: SyncSource,
        validators_for_height: Callable[[int], Mapping[bytes, int]],
    ) -> None:
        self.source = source
        self.validators_for_height = validators_for_height

    def latest_height(self) -> int:
        return self.source.latest_height()

    def build_range(
        self, start: int, end: int
    ) -> Tuple[List[ProofEntry], List[SetDiff]]:
        """Entries + rotation diffs for heights ``[start, end]`` (diffs
        include ``start`` vs ``start - 1`` — the cache-chunk shape; see
        :func:`diff_chain`).  Raises :class:`ProofError` when the source
        cannot serve the full contiguous range."""
        if start < 1 or end < start:
            raise ProofError(f"invalid proof range [{start}, {end}]")
        blocks = self.source.get_blocks(start, end)
        expected = list(range(start, end + 1))
        if [b.height for b in blocks] != expected:
            raise ProofError(
                f"source cannot serve contiguous heights [{start}, {end}]"
            )
        entries = [ProofEntry.from_block(b) for b in blocks]
        return entries, diff_chain(self.validators_for_height, start, end)

    def build(self, checkpoint_height: int, target: int) -> FinalityProof:
        """One un-cached proof for ``(checkpoint_height, target]`` (the
        cache-and-coalesce path lives in :class:`~go_ibft_tpu_torch.serve.
        server.ProofServer`; this is the direct seam tests and embedders
        without a server use)."""
        entries, diffs = self.build_range(checkpoint_height + 1, target)
        return FinalityProof(
            checkpoint_height=checkpoint_height,
            entries=entries,
            # The first proven height's set is the client's trusted
            # anchor; its diff (vs checkpoint) is never served.
            diffs=[d for d in diffs if d.height > checkpoint_height + 1],
        )
