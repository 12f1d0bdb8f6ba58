"""``python -m go_ibft_tpu_torch.node --config node.toml`` — run one validator
(the port of the JAX package's ``python -m go_ibft_tpu.node``).

Exit codes: 0 clean run/drain, 1 crash, 2 bad config.  The process
prints exactly two JSON lines on stdout — a boot line (bound ports,
resumed height) and a final drain report — so supervisors and the fleet
harness (:mod:`go_ibft_tpu_torch.sim.fleet`) parse state instead of scraping
logs.  ``--check`` validates the config and exits without binding
anything (the supervisor pre-flight).  The port's node verifies on the
card unless its config asks for the host route or the CPU
(:mod:`go_ibft_tpu_torch.node.config`); a card fault ends the process with
exit code 1 and a ``node_error`` line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m go_ibft_tpu_torch.node", description=__doc__
    )
    parser.add_argument("--config", required=True, help="path to node.toml")
    parser.add_argument(
        "--check",
        action="store_true",
        help="validate the config and exit (no sockets, no chain)",
    )
    args = parser.parse_args(argv)

    from .config import NodeConfigError, load_config

    try:
        config = load_config(args.config)
    except (OSError, NodeConfigError) as err:
        print(json.dumps({"config_error": str(err)}), flush=True)
        return 2
    if args.check:
        print(
            json.dumps(
                {
                    "config_ok": True,
                    "node": config.node_id,
                    "validators": len(config.validators),
                    "peers": len(config.consensus.peers),
                }
            ),
            flush=True,
        )
        return 0

    from .node import ValidatorNode

    try:
        node = ValidatorNode(config)
    except NodeConfigError as err:
        print(json.dumps({"config_error": str(err)}), flush=True)
        return 2
    try:
        report = asyncio.run(node.run())
    except Exception as err:  # noqa: BLE001 - the report line IS the contract
        print(json.dumps({"node_error": repr(err)}), flush=True)
        return 1
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
