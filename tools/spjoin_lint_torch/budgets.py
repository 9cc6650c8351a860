"""The collective budgets the port is held to, from two files.

* ``tools/spjoin_lint/contracts_baseline.json``, the reference's committed
  jaxpr baseline, read as data: each distributed stage's collectives,
  under the reference's primitive names, mapped onto the names the port
  counts (``distributed.collective_counts``: ``"<stage>.<op>"``).
* ``port_budgets.json`` beside this file: counts only the port has (the
  result gather of ``DistIndex.query_batch``, the mesh path's
  collectives).

This module imports nothing of the package (nor torch), so a test can load
it by file location.
"""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE = os.path.join(os.path.dirname(HERE), "spjoin_lint", "contracts_baseline.json")
PORT_BUDGETS = os.path.join(HERE, "port_budgets.json")

# The reference's stage entry -> the stage name the port counts under.
STAGES = {
    "stage_stats": "stats",
    "stage_counts": "counts",
    "stage_verify": "verify",
    "stage_verify_cross": "verify",
    "stage_serve": "serve",
}


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)["entries"]


def stage_budget(entry: str) -> dict[str, int]:
    """The port's counts for one of the reference's stage entries:
    ``{"<stage>.<primitive>": n}`` (the port's exchange is one
    ``all_to_all_single`` per buffer, counted as ``all_to_all``)."""
    collectives = _load(BASELINE)[entry]["collectives"]
    return {f"{STAGES[entry]}.{prim}": n for prim, n in collectives.items()}


def port_budget(entry: str) -> dict[str, int]:
    """The collectives of one of the port's own entries."""
    return dict(_load(PORT_BUDGETS)[entry]["collectives"])
