"""The pinned program registry: every program family a boot restores (the
port of the JAX package's ``boot/registry.py``).

The keys are the JAX registry's, letter for letter (``<family>_<shape
suffix>``, the JAX package's ``docs/compile_budget.json`` keys), and each
builder returns ``(fn, args)``: the port's function of that family and its
arguments at the JAX shape (``ENGINE_LANES`` lanes), on the registry's
device.  Calling ``fn(*args)`` once is what warms the program:
:class:`~go_ibft_tpu_torch.boot.aot.AOTStore` builds the CUDA sources the
family needs (:func:`program_sources`) and then makes that call.

Builders are lazy: constructing the registry imports nothing heavy and
resolves no device, and each builder does its own imports and argument
packing when called, so restoring one small family never pays the BLS
workload's signing.

Differences from the JAX file.  A builder returns a callable, not a
``jax.jit`` object to lower.  ``device`` (``None``: the card; ``"cpu"``
only when asked for) places the arguments; on the CPU each function takes
its kernels' plain versions.  The mesh families and ``ici_tick_8n`` run
over ``[device] * dp`` (a mesh of shards of one device, as the port's
one-card mesh does), so they never raise :class:`ProgramUnavailable` for
want of devices.  ``ecmul2_base_8l`` warms the port's
``ops/secp256k1.py::ecmul2_base``, on the card one launch of the
``secp256k1_ecmul2`` entry of ``csrc/secp256k1_recover.cu``, the source
the recovery kernel is built from.  The BLS families take the port's
point layout (12 x 32-bit words a coordinate, not the JAX package's
30 x 13-bit limbs).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..utils.device import DeviceLike

__all__ = [
    "ENGINE_LANES",
    "MESH_DPS",
    "ProgramUnavailable",
    "program_registry",
    "program_sources",
]

# The engine-route lane bucket and the dp sweep of the multi-device pins —
# the JAX registry's shapes.
ENGINE_LANES = 8
MESH_DPS = (2, 4, 8)

_KECCAK, _RECOVER, _BLS = "keccak_f1600", "secp256k1_recover", "bls12_381"
_CERTIFY = "certify_lanes"

# The CUDA sources (csrc/<name>.cu) each family's kernels come from.
# "ecdsa_recover" is also the verifier's mask dispatch (``_program_of``):
# the recovery, then ``certify_lanes`` with no phase; a warmed family has
# both built.  The mesh families end in ``certify_lanes`` too: one launch
# on the first device for the sharded certify, one a shard for the mask.
_SOURCES: Dict[str, Tuple[str, ...]] = {
    "bls_aggregate_verify": (_BLS,),
    "bls_g2_merge_tree": (_BLS,),
    "bls_g1_merge_tree": (_BLS,),
    "digest_words": (_KECCAK,),
    "bls_multipair_miller": (_BLS,),
    "quorum_certify": (_KECCAK, _RECOVER, _CERTIFY),
    "round_certify": (_KECCAK, _RECOVER, _CERTIFY),
    "ecdsa_recover": (_RECOVER, _CERTIFY),
    "ecmul2_base": (_RECOVER,),
    "ici_tick_8n": (_KECCAK,),  # family_of keeps the node suffix
    "mesh_quorum_certify": (_KECCAK, _RECOVER, _CERTIFY),
    "mesh_verify_mask": (_RECOVER, _CERTIFY),
}


class ProgramUnavailable(RuntimeError):
    """A builder's prerequisites are absent on this host; the AOT store
    records a skip, not a fault."""


def program_sources(program: str) -> Tuple[str, ...]:
    """The CUDA sources a registry key's functions launch kernels of."""
    from .aot import family_of

    return _SOURCES[family_of(program)]


def _tensors(dev, *arrays):
    import numpy as np
    import torch

    from ..verify.batch import _as_signed

    # reshape: a 0-d threshold stays 0-d (the signed view makes it 1-d).
    return tuple(torch.from_numpy(_as_signed(np.asarray(a))).reshape(np.shape(a)).to(dev) for a in arrays)


def _engine_arrays() -> dict:
    """The JAX registry's engine shapes, as the JAX package's numpy dtypes."""
    import numpy as np

    from ..ops import secp256k1 as sec

    B = ENGINE_LANES
    L = sec.FIELD.nlimbs
    return {
        "blocks": np.zeros((B, 2, 17, 2), np.uint32),
        "counts": np.ones((B,), np.int32),
        "limbs": np.zeros((B, L), np.int32),
        "v": np.zeros((B,), np.int32),
        "addr": np.zeros((B, 5), np.uint32),
        "table": np.zeros((8, 5), np.uint32),
        "live": np.zeros((B,), bool),
        "power": np.zeros((8,), np.int32),
        "hash_zw": np.zeros((B, 8), np.uint32),
        "thr": np.int32(1),
    }


def _engine(dev, *names):
    s = _engine_arrays()
    return _tensors(dev, *(s[n] for n in names))


def _bls_workload(dev):
    from ..bench.bls_workload import build_bls_round_workload

    w = build_bls_round_workload(ENGINE_LANES, time_host=False)
    return _tensors(dev, *w.args)


def _build_bls_aggregate_verify(dev):
    from ..ops.bls12_381 import aggregate_verify_commit

    return aggregate_verify_commit, _bls_workload(dev)


def _build_merge_tree(dev, coords: int):
    import numpy as np

    from ..ops.bls12_381 import g1_merge_tree, g2_merge_tree

    fn = g2_merge_tree if coords == 4 else g1_merge_tree
    return fn, _tensors(dev, np.zeros((128, coords, 12), np.int32), np.zeros((128,), bool))


def _build_multipair_miller(dev):
    import torch

    from ..ops import bls_kernels

    pk, sig, _h, _live = _bls_workload(dev)
    return bls_kernels.miller, (torch.stack([sig, sig]), torch.stack([pk, pk]))


def _build_digest_words(dev):
    from ..ops import quorum

    return quorum.digest_words, _engine(dev, "blocks", "counts")


_QUORUM_ARGS = ("blocks", "counts", "limbs", "limbs", "v", "addr", "table", "live", "power", "power", "thr", "thr")


def _build_quorum_certify(dev):
    from ..ops import quorum

    return quorum.quorum_certify, _engine(dev, *_QUORUM_ARGS)


def _build_round_certify(dev):
    from ..ops import quorum

    return quorum.round_certify, _engine(
        dev,
        "blocks", "counts", "limbs", "limbs", "v", "addr", "live",
        "hash_zw", "limbs", "limbs", "v", "addr", "live",
        "table", "power", "power", "thr", "thr",
    )


def _build_ecdsa_recover(dev):
    from ..ops import secp256k1 as sec

    return sec.ecdsa_recover, _engine(dev, "limbs", "limbs", "limbs", "v")


def _build_ecmul2_base(dev):
    from ..ops import secp256k1 as sec

    return sec.ecmul2_base, _engine(dev, "limbs", "limbs", "limbs", "limbs")


def _one_device_mesh(dev, dp: int):
    from ..parallel import make_mesh

    return make_mesh(dp, devices=[dev] * dp)


def _build_mesh_quorum_certify(dev, dp: int):
    from ..parallel import mesh_quorum_certify

    return mesh_quorum_certify(_one_device_mesh(dev, dp)), _engine(dev, *_QUORUM_ARGS)


def _build_mesh_verify_mask(dev, dp: int):
    import numpy as np

    from ..ops import secp256k1 as sec
    from ..verify.batch import _DigestLanes
    from ..verify.mesh_batch import mesh_verify_mask

    mask = mesh_verify_mask(_one_device_mesh(dev, dp))
    g = ENGINE_LANES * dp  # 8 local lanes per shard
    L = sec.FIELD.nlimbs
    lanes = _DigestLanes(
        np.zeros((g, 8), np.uint32),
        np.zeros((g, L), np.int32),
        np.zeros((g, L), np.int32),
        np.zeros((g,), np.int32),
        np.zeros((g, 5), np.uint32),
        np.zeros((g,), bool),
    )

    def verify_mask(lanes, table):
        return mask(lanes, mask.tables(table))

    return verify_mask, (lanes, np.zeros((8, 5), np.uint32))


def _build_ici_tick(dev, n_nodes: int):
    """The lock-step tick (rows variant) at the real-crypto cluster shape:
    ``n_nodes`` nodes on ``n_nodes`` shards, 8 lanes of 512-byte slots."""
    import numpy as np

    from ..net.ici import build_tick_program
    from ..ops import secp256k1 as sec

    m_slots, b = ENGINE_LANES, 512
    lanes = n_nodes * m_slots
    L = sec.FIELD.nlimbs
    from ..parallel.mesh import Mesh

    return build_tick_program(Mesh([dev] * n_nodes, ("node",)), rows=True), (
        np.zeros((n_nodes, m_slots, b), np.uint8),
        np.zeros((lanes, 8, 17, 2), np.uint32),
        np.ones((lanes,), np.int32),
        np.zeros((lanes, L), np.int32),
        np.zeros((lanes, L), np.int32),
        np.zeros((lanes,), np.int32),
        np.zeros((lanes, 5), np.uint32),
        np.zeros((lanes,), bool),
    )


def program_registry(
    programs: Optional[Sequence[str]] = None,
    *,
    device: DeviceLike = None,
) -> "OrderedDict[str, Callable[[], Tuple[object, tuple]]]":
    """``name -> builder`` for every pinned family (optionally filtered).

    Each builder returns ``(fn, args)`` on ``device`` (resolved when the
    builder runs: ``None`` is the card).  Unknown names in ``programs``
    raise ``KeyError`` — a boot manifest naming a family this registry
    does not pin is a configuration error, not a skip.
    """

    def on_device(build, *extra):
        def builder():
            from ..utils.device import resolve_device

            return build(resolve_device(device), *extra)

        return builder

    defs: "OrderedDict[str, Callable]" = OrderedDict(
        (
            ("bls_aggregate_verify_8v", on_device(_build_bls_aggregate_verify)),
            ("bls_g2_merge_tree_128v", on_device(_build_merge_tree, 4)),
            ("bls_g1_merge_tree_128v", on_device(_build_merge_tree, 2)),
            ("digest_words_8l", on_device(_build_digest_words)),
            ("bls_multipair_miller_8l", on_device(_build_multipair_miller)),
            ("quorum_certify_8l", on_device(_build_quorum_certify)),
            ("round_certify_8l", on_device(_build_round_certify)),
            ("ecdsa_recover_8l", on_device(_build_ecdsa_recover)),
            ("ecmul2_base_8l", on_device(_build_ecmul2_base)),
            ("ici_tick_8n", on_device(_build_ici_tick, 8)),
        )
    )
    for dp in MESH_DPS:
        defs[f"mesh_quorum_certify_8l_dp{dp}"] = on_device(_build_mesh_quorum_certify, dp)
        defs[f"mesh_verify_mask_8l_dp{dp}"] = on_device(_build_mesh_verify_mask, dp)
    if programs is None:
        return defs
    out: "OrderedDict[str, Callable]" = OrderedDict()
    for name in programs:
        out[name] = defs[name]
    return out
