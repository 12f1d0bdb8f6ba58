"""Where the benchmark reads and writes.

Everything it builds or caches lies under ``build/`` at the root of the
checkout, at fixed paths, so that only the first run in a checkout builds:
the port's kernels in ``build/torch_kernels`` and its native library in
``build/torch_native`` (the program's own defaults, named here so that the
program takes them from the benchmark), the benchmark's signer and signed
traffic in ``build/portbench``.  A run's write-ahead logs go under
``TMPDIR`` and are deleted when the run ends.
"""

from __future__ import annotations

import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)
BUILD_ROOT = os.path.join(REPO_ROOT, "build")


def build_dir(*parts: str) -> str:
    path = os.path.join(BUILD_ROOT, "portbench", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def program_environment() -> dict:
    """Environment the program is run with: its caches inside the checkout,
    no calibration record (the node's default when none was written), and
    no JAX pulled in by a library."""
    return {
        "GO_IBFT_TORCH_CACHE_DIR": os.path.join(BUILD_ROOT, "torch_kernels"),
        "TORCH_EXTENSIONS_DIR": os.path.join(BUILD_ROOT, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(BUILD_ROOT, "triton"),
        "GO_IBFT_TORCH_CALIBRATION_FILE": os.path.join(BUILD_ROOT, "portbench", "no-calibration.json"),
        "USE_FLAX": "0",
    }
