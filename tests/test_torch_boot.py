"""The port's boot layer (``go_ibft_tpu_torch/boot``, ``utils/buildcache.py``,
``_build.build_all``'s report) against the JAX package's, on the CPU.

Mirrors ``tests/test_boot.py``: the registry's keys are the JAX registry's,
letter for letter, and each engine-shaped family's arguments have the JAX
shapes; ``family_of`` is the JAX function; the fingerprint carries the
port's artifact-validity key; the manifest round-trips and flags staleness;
a stale sidecar never counts as cached; the WAL's seals seed the verdict
caches with keys identical to the JAX function's, and ``warm_start`` on a
recovered runner gives the JAX height and seeded counts.  On the CPU the
store builds nothing (each program runs its plain path and is "cached"); a
second boot in a child process reports zero cold programs and zero compile
events; a fault in a program propagates out of the store.  The kernel build
cache's report (compiled against found built) is checked with a stand-in
``nvcc``.
"""

import json
import os
import stat

import numpy as np
import pytest
import torch
from test_torch_chain import PACKAGES, pkg
from test_torch_chain_sync import _signed_range

from go_ibft_tpu.boot import aot as jax_aot
from go_ibft_tpu.boot import registry as jax_registry
from go_ibft_tpu.boot import warmstart as jax_warmstart
from go_ibft_tpu_torch import _build
from go_ibft_tpu_torch.boot import aot, registry, restart, warmstart
from go_ibft_tpu_torch.utils import buildcache

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# Families whose arguments are the engine's limbs and words in both
# packages (the BLS families take another point layout).
_ENGINE_FAMILIES = [k for k in jax_registry.program_registry() if not k.startswith("bls_")]


# -- registry ------------------------------------------------------------------


def test_registry_keys_equal_the_jax_registry():
    assert list(registry.program_registry()) == list(jax_registry.program_registry())
    assert registry.ENGINE_LANES == jax_registry.ENGINE_LANES and registry.MESH_DPS == jax_registry.MESH_DPS
    with open(os.path.join(REPO, "docs", "compile_budget.json")) as fh:
        pinned = {k for k in json.load(fh) if not k.startswith("_")}
    assert set(registry.program_registry()) == pinned


def test_registry_selection_and_unknown_program():
    assert list(registry.program_registry(["digest_words_8l"])) == ["digest_words_8l"]
    with pytest.raises(KeyError):
        registry.program_registry(["not_a_pinned_program"])


def _shapes(args) -> list:
    out = []
    for a in args:
        fields = getattr(a, "__dataclass_fields__", None)
        if fields is not None:  # a packed lane chunk: its arrays in order
            out.extend(tuple(np.shape(getattr(a, f))) for f in fields)
        else:
            out.append(tuple(np.shape(a)))
    return out


@pytest.mark.parametrize("program", _ENGINE_FAMILIES)
def test_registry_arguments_have_the_jax_shapes(program):
    """Each engine-shaped builder gives the port's function its arguments at
    the JAX registry's shapes, on the CPU asked for (mesh families over a
    mesh of shards of that one device; the sharded mask takes its lanes as
    one packed chunk and the table after them, so its shapes are compared
    as a multiset)."""
    _fn, args = registry.program_registry([program], device="cpu")[program]()
    _jfn, jargs = jax_registry.program_registry([program])[program]()
    if program.startswith("mesh_verify_mask"):
        assert sorted(_shapes(args)) == sorted(_shapes(jargs))
    else:
        assert _shapes(args) == _shapes(jargs)
    assert all(a.device == CPU for a in args if isinstance(a, torch.Tensor))


@pytest.mark.parametrize("program", list(jax_registry.program_registry()) + ["ecmul2_base", "x_8v_dp2"])
def test_family_of_is_the_jax_function(program):
    assert aot.family_of(program) == jax_aot.family_of(program)


def test_family_of_strips_shape_suffixes_iteratively():
    assert aot.family_of("digest_words_8l") == "digest_words"
    assert aot.family_of("bls_g2_merge_tree_128v") == "bls_g2_merge_tree"
    assert aot.family_of("mesh_verify_mask_8l_dp4") == "mesh_verify_mask"
    assert aot.family_of("ecmul2_base") == "ecmul2_base"


def test_program_sources_name_the_kernels_each_family_launches():
    assert registry.program_sources("digest_words_8l") == ("keccak_f1600",)
    assert registry.program_sources("round_certify_8l") == ("keccak_f1600", "secp256k1_recover", "certify_lanes")
    assert registry.program_sources("mesh_verify_mask_8l_dp8") == ("secp256k1_recover", "certify_lanes")
    assert registry.program_sources("mesh_quorum_certify_8l_dp2") == ("keccak_f1600", "secp256k1_recover",
                                                                       "certify_lanes")
    assert registry.program_sources("bls_aggregate_verify_8v") == ("bls12_381",)
    assert registry.program_sources("ecmul2_base_8l") == ("secp256k1_ecmul2",)
    for program in registry.program_registry():
        assert set(registry.program_sources(program)) <= set(_build.SIGNATURES)


# -- fingerprint, manifest, sidecars --------------------------------------------


def test_fingerprint_carries_the_artifact_validity_key():
    fp = aot.fingerprint()
    assert set(fp) == {"torch", "cuda", "device", "device_count", "nvcc", "sources"}
    assert fp["torch"] == torch.__version__ and fp["cuda"] == torch.version.cuda
    assert fp["sources"] == _build.source_key()
    if not torch.cuda.is_available():
        assert (fp["device"], fp["device_count"]) == ("none", 0)


def test_manifest_roundtrip_and_staleness(tmp_path):
    path = str(tmp_path / "aot_manifest.json")
    doc = aot.write_manifest(path, {"digest_words": {"compile_ms": 430.5, "events": 1}}, sizes=[8, 64])
    assert doc["programs"]["digest_words"]["compile_ms"] == 430.5
    loaded = aot.load_manifest(path)
    assert loaded is not None and loaded["stale"] is False
    doc["fingerprint"]["sources"] = "0" * 16  # another kernel source
    with open(path, "w") as fh:
        json.dump(doc, fh)
    assert aot.load_manifest(path)["stale"] is True
    assert aot.load_manifest(str(tmp_path / "missing.json")) is None


def test_stale_sidecar_never_counts_as_cached(tmp_path):
    store = aot.AOTStore(str(tmp_path), device="cpu")
    good = {
        "program": "digest_words_8l",
        "family": "digest_words",
        "fingerprint": aot.fingerprint(),
        "status": "cold",
        "compile_ms": 430.0,
    }
    store._write_sidecar("digest_words_8l", good)
    assert store.cached_programs() == {"digest_words_8l"}
    for key, other in (("device", "another card"), ("nvcc", "0.0, V0.0.0"), ("torch", "0.0.1")):
        store._write_sidecar("digest_words_8l", dict(good, fingerprint=dict(good["fingerprint"], **{key: other})))
        assert store.cached_programs() == set()
    with open(store._sidecar_path("digest_words_8l"), "w") as fh:
        fh.write("not json")
    assert store.cached_programs() == set()


# -- the store on the CPU ---------------------------------------------------------


def test_ensure_on_the_cpu_builds_nothing_and_runs_the_plain_path(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "build_all", lambda *a, **k: pytest.fail("nothing builds on the CPU"))
    store = aot.AOTStore(str(tmp_path), device="cpu")
    out = store.ensure(["digest_words_8l", "ici_tick_8n"])
    for program, st in out.items():
        assert (st.status, st.compile_ms, st.reason) == ("cached", 0.0, aot.CPU_REASON)
        side = store.read_sidecar(program)
        assert side["status"] == "cached" and side["device"] == "cpu" and side["compiled"] == []
    assert store.cached_programs() == {"digest_words_8l", "ici_tick_8n"}


def test_a_program_fault_propagates_out_of_the_store(tmp_path, monkeypatch):
    def boom(*_):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(aot, "program_registry", lambda programs=None, device=None: {"digest_words_8l": lambda: (boom, ())})
    store = aot.AOTStore(str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        store.ensure(["digest_words_8l"])
    assert store.read_sidecar("digest_words_8l") is None


def test_unavailable_program_is_a_recorded_skip(tmp_path, monkeypatch):
    def absent():
        raise registry.ProgramUnavailable("not on this host")

    monkeypatch.setattr(aot, "program_registry", lambda programs=None, device=None: {"digest_words_8l": absent})
    out = aot.AOTStore(str(tmp_path), device="cpu").ensure()
    assert out["digest_words_8l"].status == "skipped" and out["digest_words_8l"].reason == "not on this host"


def _boot_leg(tag, cache_dir, tmp_path):
    return restart.run_boot_leg(tag, "digest_words_8l", cache_dir, str(tmp_path / f"ledger_{tag}.jsonl"),
                                timeout_s=240, cwd=REPO, device="cpu", chain=False)


def test_second_boot_in_a_child_reports_zero_cold(tmp_path):
    """``python -m go_ibft_tpu_torch.boot --device cpu --no-chain`` twice on
    one cache directory: on the CPU nothing is built, so both legs report
    the program cached and their ledgers hold no compile event."""
    cache_dir = str(tmp_path / "kernels")
    for tag in ("first", "second"):
        leg = _boot_leg(tag, cache_dir, tmp_path)
        report = leg["report"]
        assert (report["platform"], report["device"], report["cold"], report["cached"]) == ("cpu", "cpu", 0, 1)
        assert report["programs"]["digest_words_8l"] == {"status": "cached", "compile_ms": 0.0}
        assert report["cache_dir"] == cache_dir and leg["events"] == []
    side = aot.AOTStore(cache_dir).read_sidecar("digest_words_8l")
    assert side["device"] == "cpu" and side["compiled"] == [] and not list(os.scandir(cache_dir))[1:]


def test_boot_leg_timeout_and_failure_raise(tmp_path):
    with pytest.raises(RuntimeError, match="rc=1") as err:
        restart.run_boot_leg("bad", "not_a_pinned_program", str(tmp_path), str(tmp_path / "l.jsonl"),
                             timeout_s=240, cwd=REPO, device="cpu", chain=False)
    assert "KeyError: 'not_a_pinned_program'" in str(err.value)
    err = restart.BootLegTimeout("cold", 5.0)
    assert err.tag == "cold" and "5s" in str(err)


# -- the kernel build cache ------------------------------------------------------


def test_cache_dir_resolves_explicit_then_env_then_default(monkeypatch, tmp_path):
    monkeypatch.setattr(buildcache, "_enabled", None)
    monkeypatch.delenv("GO_IBFT_TORCH_CACHE_DIR", raising=False)
    assert buildcache.resolve_cache_dir() == buildcache.DEFAULT_DIR
    assert buildcache.DEFAULT_DIR == os.path.join(REPO, "build", "torch_kernels")
    monkeypatch.setenv("GO_IBFT_TORCH_CACHE_DIR", str(tmp_path / "env"))
    assert buildcache.resolve_cache_dir() == str(tmp_path / "env")
    assert buildcache.resolve_cache_dir(str(tmp_path / "arg")) == str(tmp_path / "arg")


def test_enable_points_the_builds_at_the_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(buildcache, "_enabled", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    target = buildcache.enable_persistent_cache(str(tmp_path / "k"))
    assert target == str(tmp_path / "k") and os.path.isdir(target)
    assert _build.BUILD_DIR == tmp_path / "k" and _build._target("keccak_f1600").parent == tmp_path / "k"
    assert buildcache.resolve_cache_dir() == target == buildcache.enable_persistent_cache()


def test_prune_drops_stale_then_oldest(tmp_path):
    for i, (age, size) in enumerate(((10, 100), (5, 100), (1, 100), (1000, 50))):
        p = tmp_path / f"f{i}.so"
        p.write_bytes(b"x" * size)
        os.utime(p, (1_000_000 - age, 1_000_000 - age))
    removed, freed = buildcache.prune_cache(str(tmp_path), max_bytes=150, max_age_s=500, now=1_000_000)
    assert (removed, freed) == (3, 250)
    assert [p.name for p in tmp_path.iterdir()] == ["f2.so"]
    assert buildcache.prune_cache(str(tmp_path / "missing")) == (0, 0)


def _fake_nvcc(tmp_path) -> str:
    """A stand-in ``nvcc`` that writes its ``-o`` file and counts its calls."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo x >> {tmp_path}/calls\n"
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then echo lib > "$2"; fi; shift; done\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_all_reports_compiled_and_ready(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    first = _build.build_all(["keccak_f1600", "secp256k1_recover"])
    assert first.compiled == ("keccak_f1600", "secp256k1_recover") and first.ready == ()
    assert all(p.exists() for p in first.values()) and first.build_s >= 0
    second = _build.build_all(["keccak_f1600", "secp256k1_recover", "bls12_381"])
    assert second.compiled == ("bls12_381",) and second.ready == ("keccak_f1600", "secp256k1_recover")
    assert len((tmp_path / "calls").read_text().split()) == 3  # one nvcc a compiled source
    assert not list((tmp_path / "kernels").glob("*.tmp"))  # renamed into place


def test_ensure_classifies_cold_by_what_the_build_compiled(tmp_path, monkeypatch):
    """The card path's classification with the build and the launches
    stood in for: a program whose source the call compiled is cold and
    recorded to the ledger (``ecmul2_base_8l`` too: its kernel is built from
    ``secp256k1_ecmul2``); one whose library was built already is cached;
    a cached second store records nothing."""
    from go_ibft_tpu_torch.obs import ledger

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(buildcache, "_enabled", None)
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    card = torch.device("cuda", 0)
    monkeypatch.setattr(aot, "program_registry", lambda programs=None, device=None: {
        p: (lambda: (lambda: None, ())) for p in programs})
    monkeypatch.setattr("go_ibft_tpu_torch.utils.device.resolve_device", lambda device=None: card)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    events = []
    monkeypatch.setattr(ledger, "record_compile", lambda program, ms, site="", **kw: events.append(program))
    programs = ["digest_words_8l", "ecmul2_base_8l"]
    cold = aot.AOTStore(str(tmp_path / "cache"), device="cuda").ensure(programs)
    assert {p: s.status for p, s in cold.items()} == {"digest_words_8l": "cold", "ecmul2_base_8l": "cold"}
    assert events == ["digest_words", "ecmul2_base"] and cold["digest_words_8l"].compile_ms > 0
    cached = aot.AOTStore(str(tmp_path / "cache"), device="cuda").ensure(programs, export=True)
    assert {s.status for s in cached.values()} == {"cached"} and events == ["digest_words", "ecmul2_base"]
    side = aot.AOTStore(str(tmp_path / "cache")).read_sidecar("digest_words_8l")
    assert side["libraries"] == [_build._target("keccak_f1600").name] and side["exported"] is True
    side = aot.AOTStore(str(tmp_path / "cache")).read_sidecar("ecmul2_base_8l")
    assert side["libraries"] == [_build._target("secp256k1_ecmul2").name]
    mixed = aot.AOTStore(str(tmp_path / "cache"), device="cuda").ensure(["ecmul2_base_8l", "bls_g1_merge_tree_128v"])
    assert {p: s.status for p, s in mixed.items()} == {"ecmul2_base_8l": "cached", "bls_g1_merge_tree_128v": "cold"}
    assert events == ["digest_words", "ecmul2_base", "bls_g1_merge_tree"]


# -- warm start --------------------------------------------------------------------


class _Handle:
    def __init__(self):
        self.entries = []

    def seed_seal_verdicts(self, entries) -> int:
        self.entries.extend(entries)
        return len(self.entries)


class _SigCache:
    def __init__(self):
        self.stored = {}

    def store_batch(self, keys, verdicts) -> None:
        self.stored.update(zip(keys, verdicts))


def _blocks(m):
    blocks, keys, src = _signed_range(m, n_validators=4, heights=(1, 2, 3))
    # An aggregate-certificate block and a sealless block carry no lanes.
    prop = m.wire.Proposal(raw_proposal=b"cert block", round=0)
    blocks.append(m.chain.FinalizedBlock(4, prop, [], cert=object()))
    blocks.append(m.chain.FinalizedBlock(5, prop, []))
    return blocks, keys, src


def test_seed_verdict_caches_keys_equal_jax():
    seeded = {}
    for name, seed in zip(PACKAGES, (warmstart.seed_verdict_caches, jax_warmstart.seed_verdict_caches)):
        blocks, _, _ = _blocks(pkg(name))
        handle, sig_cache = _Handle(), _SigCache()
        out = seed(blocks, handle=handle, sig_cache=sig_cache)
        seeded[name] = (out, handle.entries, sorted(sig_cache.stored.items()))
    assert seeded[PACKAGES[0]] == seeded[PACKAGES[1]]
    out, entries, stored = seeded[PACKAGES[0]]
    assert out == {"seal_verdicts": 12, "sig_verdicts": 12} and len(entries) == len(stored) == 12
    assert all(v is True for _, v in entries) and {k[3] for k, _ in entries} == {1, 2, 3}
    # max_blocks keeps the newest blocks only.
    blocks, _, _ = _blocks(pkg(PACKAGES[0]))
    assert warmstart.seed_verdict_caches(blocks, handle=_Handle(), max_blocks=3)["seal_verdicts"] == 4


def test_warm_start_on_a_recovered_runner_matches_jax(tmp_path):
    """A WAL of 3 finalized 4-validator heights and a lock: the port's
    ``ChainRunner.warm_start`` (the delegation to ``boot.warmstart``)
    recovers to the JAX runner's height and seeds the same verdicts."""
    got = {}
    for name in PACKAGES:
        m = pkg(name)
        blocks, keys, src = _signed_range(m, n_validators=4, heights=(1, 2, 3))
        path = str(tmp_path / f"{name}.jsonl")
        wal = m.chain.WriteAheadLog(path)
        for b in blocks:
            wal.append_finalize(b.height, b.proposal, b.seals)
        wal.close()
        engine = m.core.IBFT(None, m.cb.ECDSABackend(keys[0], src), None)
        runner = m.chain.ChainRunner(engine, m.chain.WriteAheadLog(path))
        handle, sig_cache = _Handle(), _SigCache()
        kw = {"device": "cpu"} if name == PACKAGES[0] else {}
        report = runner.warm_start(programs=[], handle=handle, sig_cache=sig_cache, **kw)
        got[name] = (report.height, report.seeded_seal_verdicts, report.seeded_sig_verdicts,
                     handle.entries, sorted(sig_cache.stored), report.programs)
        runner.wal.close()
    assert got[PACKAGES[0]] == got[PACKAGES[1]]
    assert got[PACKAGES[0]][:3] == (4, 12, 12)


def test_warm_start_manifest_selects_and_runs_warmups(tmp_path):
    calls = []
    store = aot.AOTStore(str(tmp_path), device="cpu")
    aot.write_manifest(str(tmp_path / "m.json"), {"digest_words": {"compile_ms": 1.0, "events": 1}})
    report = warmstart.warm_start(manifest=str(tmp_path / "m.json"), store=store, warmups=[lambda: calls.append(1)])
    assert list(report.programs) == ["digest_words_8l"] and calls == [1]
    assert report.cache_dir == str(tmp_path) and len(report.cached) == 1 and report.cold == report.skipped == []
    assert report.total_ms >= report.warmup_ms >= 0
