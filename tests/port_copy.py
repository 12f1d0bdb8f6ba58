"""Run a test file of the JAX package against the port.

:func:`port_module` executes ``tests/<filename>`` with every import of
``go_ibft_tpu`` rewritten to ``go_ibft_tpu_torch`` and every import of the
cluster harness (``tests.harness`` / ``harness``) rewritten to its port copy,
``harness_torch`` (``tests/harness.py`` run the same way).  The file itself
is not edited.  :func:`expose` puts the copy's tests and fixtures into a test
module's namespace, where pytest collects them.
"""

from __future__ import annotations

import re
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
HARNESS = "harness_torch"


def port_module(filename: str, name: str) -> types.ModuleType:
    """``tests/<filename>`` on the port, as module ``name``."""
    if filename != "harness.py" and HARNESS not in sys.modules:
        port_module("harness.py", HARNESS)
    src = re.sub(r"\bgo_ibft_tpu\b", "go_ibft_tpu_torch", (TESTS / filename).read_text())
    src = re.sub(r"from (tests\.)?harness import", f"from {HARNESS} import", src)
    mod = types.ModuleType(name)
    mod.__file__ = str(TESTS / filename)
    sys.modules[name] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def _is_fixture(obj) -> bool:
    return hasattr(obj, "_fixture_function_marker") or hasattr(obj, "_pytestfixturefunction")


def expose(mod: types.ModuleType, namespace: dict) -> list:
    """Copy ``mod``'s tests and fixtures into ``namespace``; returns the
    names of the tests."""
    tests = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and callable(obj):
            if name in namespace:
                raise NameError(f"{name} of {mod.__name__} is already defined")
            namespace[name] = obj
            tests.append(name)
        elif _is_fixture(obj):
            namespace[name] = obj
    return tests
