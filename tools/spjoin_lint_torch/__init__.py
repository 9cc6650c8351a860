"""spjoin-lint-torch: the contract checker of the PyTorch/CUDA port.

The counterpart of ``tools/spjoin_lint`` for ``src/repro_torch``, in two
layers (docs/CONTRACTS_TORCH.md):

Layer 1 (``astlint``/``rules``): AST rules over the port's core, kernels,
models, train and launch packages: host syncs (banned in the LM step
functions, counted against a budget in the streaming loops), the dispatch
triad, float64, collective sites, kernel confinement, layering and waiver
hygiene.

Layer 2 (``audit``): runs the port on the CPU at small sizes and compares
what it does with budgets: no float64 op in any ``ops.*`` wrapper or
verify tile, and each distributed stage's collectives equal to the
reference's baseline (``tools/spjoin_lint/contracts_baseline.json``, read
as data) and the port's own budgets (``port_budgets.json``).

Run ``python -m spjoin_lint_torch [paths]`` (layer 1) or add ``--audit``.
Nothing here imports ``jax``, ``repro`` or ``spjoin_lint``.
"""
from __future__ import annotations

__version__ = "0.1.0"
