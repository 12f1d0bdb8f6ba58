"""The reference's wire corpora on the port's ``messages/``.

The cases of ``tests/test_wire.py``, ``test_wire_fuzz.py``,
``test_wire_interop.py``, ``test_wire_merge.py`` and ``test_helpers.py`` run
here against ``go_ibft_tpu_torch.messages`` (each file executed with its
imports rewritten, ``tests/port_copy.py``; the files are not edited).  The
interop cases skip without ``google.protobuf``, as the JAX file's do.

Then both packages meet on the same seeds: the fuzz corpus's random
messages (every type, nested certificates) encode to identical bytes, with
and without the signature, and the same mutated and garbage bytes decode
to identical messages or fail with identical errors.  Tolerance: byte
equality, and equal error types and texts.
"""

import random

import pytest

from go_ibft_tpu.messages import wire as jax_wire
from go_ibft_tpu_torch.messages import wire as port_wire
from tests import test_wire_fuzz as jax_fuzz
from tests.port_copy import expose, port_module

COPIED = []
_PORT_FUZZ = port_module("test_wire_fuzz.py", "torch_test_wire_fuzz")
COPIED += expose(_PORT_FUZZ, globals())
for _file in ("test_wire.py", "test_wire_merge.py", "test_helpers.py"):
    COPIED += expose(port_module(_file, "torch_" + _file[:-3]), globals())
try:
    COPIED += expose(port_module("test_wire_interop.py", "torch_test_wire_interop"), globals())
except pytest.skip.Exception as _skip:  # no google.protobuf: the JAX file skips too
    _NO_PROTOBUF = str(_skip)

    def test_wire_interop_cases():
        pytest.skip(_NO_PROTOBUF)



def test_the_copied_cases_run_the_port():
    assert len(COPIED) == 43
    assert _PORT_FUZZ.IbftMessage is port_wire.IbftMessage
    assert globals()["test_roundtrip_all_types"].__globals__["IbftMessage"] is port_wire.IbftMessage


def _both(seed, make):
    """``make(fuzz_module, rng)`` in each package from the same seed."""
    return make(jax_fuzz, random.Random(seed)), make(_PORT_FUZZ, random.Random(seed))


def _decoded(wire_module, blob: bytes):
    try:
        return ("message", wire_module.IbftMessage.decode(blob).encode())
    except Exception as err:  # noqa: BLE001 - the error itself is compared
        return ("error", type(err).__name__, str(err))


@pytest.mark.parametrize("seed", range(8))
def test_random_messages_encode_byte_identical_to_jax(seed):
    def forty(fuzz, rng):
        return [fuzz._rand_message(rng) for _ in range(40)]

    ref, ours = _both(seed, forty)
    for a, b in zip(ref, ours):
        assert a.encode() == b.encode()
        assert a.payload_no_sig() == b.payload_no_sig()
        assert _decoded(jax_wire, a.encode()) == _decoded(port_wire, b.encode())


@pytest.mark.parametrize("seed", range(4))
def test_mutated_bytes_decode_identically_to_jax(seed):
    """The fuzz file's mutations (overwrite, delete, insert), the same on
    both sides: identical messages or identical errors."""

    def mutated(fuzz, rng):
        out = []
        for _ in range(60):
            wire = bytearray(fuzz._rand_message(rng).encode())
            for _ in range(rng.randint(1, 4)):
                if not wire:
                    break
                op = rng.random()
                if op < 0.5:
                    wire[rng.randrange(len(wire))] = rng.getrandbits(8)
                elif op < 0.75:
                    del wire[rng.randrange(len(wire))]
                else:
                    wire.insert(rng.randrange(len(wire) + 1), rng.getrandbits(8))
            out.append(bytes(wire))
        return out

    ref, ours = _both(2000 + seed, mutated)
    assert ref == ours
    outcomes = [(_decoded(jax_wire, blob), _decoded(port_wire, blob)) for blob in ours]
    assert all(a == b for a, b in outcomes)
    assert any(a[0] == "error" for a, _ in outcomes) and any(a[0] == "message" for a, _ in outcomes)


def test_garbage_decodes_identically_to_jax():
    rng = random.Random(78)
    for _ in range(300):
        blob = bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 200)))
        assert _decoded(jax_wire, blob) == _decoded(port_wire, blob)
