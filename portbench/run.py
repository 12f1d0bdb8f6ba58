"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``go_ibft_tpu_torch``)
on a machine with an NVIDIA card.  A run builds or loads the port's kernels,
signs (or loads) its traffic from ``--seed``, warms up, measures for
``--seconds``, judges what the program answered against the plain reference
(``portbench/reference``), and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read from
the program's spans and a profiler trace of the card.  The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under ``checks``, the line's last key.

It exits with a code other than 0, and prints no result, where no card is
present, where the program cannot be imported, or where JAX or the JAX
package was loaded.  ``--fault`` plants one of the faults that the
benchmark's tests use (``portbench/harness/proxies.py``); the benchmark's
own runs plant none.
"""

import os
import sys
import time


def _process_start() -> float:
    """This process's start on the ``time.monotonic`` clock."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.monotonic() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def main(argv=None) -> int:
    import argparse

    process_start = _process_start()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = root
    else:
        sys.path.insert(0, root)
    from portbench.harness import paths
    from portbench.harness.proxies import FAULTS

    os.environ.update(paths.program_environment())

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--fault", default=None, choices=FAULTS)
    args = parser.parse_args(argv)

    import json

    from portbench.harness import runner

    manifest = runner.load_manifest()
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(args.workload)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} NVIDIA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                             process_start=process_start, fault=args.fault, manifest=manifest)
    found = runner.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    notes = result.pop("notes")
    for note in notes:
        print(f"portbench: {note}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
