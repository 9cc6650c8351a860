"""Rule configuration for the port's contract checker.

Everything specific to ``src/repro_torch`` lives here: which modules are in
scope, which functions are hot (and in which tier), each stream scope's
sync budget, where collectives are blessed, and the waiver ratchet. The
rule implementations in ``rules.py`` are generic; this file is the policy.

Two tiers of hot scope (docs/CONTRACTS_TORCH.md):

  "step"    an LM step function: the transformer's forward and
            ``decode_step``, the attention, MoE, SSM and xLSTM blocks, and
            the closures ``train/train_step.py`` returns. Their bodies run
            once per token or per training step and queue work on the
            card; a host sync there stalls the queue. Every sync construct
            is flagged, as is ``int()``/``float()``/``bool()`` (or an
            ``if``/``while``/``assert``) on a tensor. The functions they call
            in the same module join the tier, to a fixpoint.
  "stream"  a host-side streaming driver: the verify engine's tile loop and
            the index's and the distributed index's query and insert paths.
            Syncs are its job, but a sync per tile is the difference between
            streaming and stalling, so the sync sites inside its loop bodies
            are COUNTED against the scope's budget below, not banned. The
            budget is a ratchet: the count must equal it, so a new per-tile
            read fails the check and a removed one asks for the budget to
            come down with it.
"""
from __future__ import annotations

# Rule identifiers (the names used in `# spjoin-lint-torch: allow[...]` waivers).
RULES = (
    "host-sync",  # no host/device sync in step scopes; counted per stream scope
    "dispatch-triad",  # ops.py public fns reach a ref oracle + a CUDA wrapper + dispatch
    "f64-cast",  # no float64 in kernels/ or step scopes
    "collective-site",  # torch.distributed collectives only at blessed sites
    "kernel-confined",  # only kernels/ touches the CUDA wrapper modules, ctypes, _build
    "layering",  # no jax / jaxlib / repro import
    "waiver-hygiene",  # waivers are justified, known, used, and bounded
)

# Files the checker runs over, as posix-path fragments.
LINT_ROOTS = (
    "repro_torch/core/",
    "repro_torch/kernels/",
    "repro_torch/models/",
    "repro_torch/train/",
    "repro_torch/launch/",
)

# The package the rules resolve imports within (cross-module return kinds).
PACKAGE = "repro_torch"

# ---------------------------------------------------------------------------
# Hot scopes
# ---------------------------------------------------------------------------

# Stream scopes and their budgets: the number of host-sync sites inside the
# scope's for/while bodies (comprehensions there included). Qualnames are
# dotted nesting ("Class.method", "outer.inner").
#
# verify_cell_lists: per cell, the two host-to-device copies of the cell's
# row indices; per tile, the mask path's whole-tile skip read
# (``int(cand.sum())``), its ``nonzero`` and the emission rule's two
# boolean-mask selects, and the compact path's one counter read
# (``counts_dev.tolist()``). ROADMAP §2 A lowers this number.
# _flush_window_batch (the plain window path, per bucket shape): the cell
# ids' host-to-device copy, the ``nonzero`` and the two mask selects.
STREAM_SCOPES: dict[str, dict[str, int]] = {
    "repro_torch/core/verify.py": {
        "verify_cell_lists": 7,
        "verify_pairs": 0,
        "verify_resident": 0,
        "prune_band": 0,
        "_flush_window_batch": 4,
    },
    "repro_torch/core/index.py": {
        "MetricIndex.route": 0,
        "MetricIndex.query_batch": 0,
        "MetricIndex.query": 0,
        "MetricIndex.insert_batch": 0,
    },
    "repro_torch/core/distributed.py": {
        "DistIndex.query_batch": 0,
        "DistIndex.insert_batch": 0,
    },
}

# The stream scope whose budget chip_smoke's contracts phase holds the
# measured syncs per tile against.
TILE_LOOP = ("repro_torch/core/verify.py", "verify_cell_lists")

# Step scopes (roots; same-module callees join them).
STEP_SCOPES: dict[str, frozenset[str]] = {
    "repro_torch/models/transformer.py": frozenset(
        {"forward", "decode_step", "Transformer.forward", "Transformer.decode_step",
         "ShardedTransformer.forward", "ShardedTransformer.decode_step"}
    ),
    "repro_torch/models/attention.py": frozenset({"attention_block", "decode_attention"}),
    "repro_torch/models/moe.py": frozenset({"moe_block"}),
    "repro_torch/models/ssm.py": frozenset(
        {"mamba2_block", "chunked_linear_recurrence", "linear_recurrence_step"}
    ),
    "repro_torch/models/xlstm.py": frozenset({"mlstm_block", "slstm_block"}),
    "repro_torch/train/train_step.py": frozenset(
        {
            "make_loss_fn.loss_fn",
            "make_grad_fn.grad_fn",
            "make_train_step.train_step",
            "make_mesh_loss_fn.loss_fn",
            "make_mesh_train_step.train_step",
            "make_eval_step.eval_step",
            "make_serve_step.serve_step",
            "make_prefill_step.prefill_step",
        }
    ),
}

# Host syncs a step scope may make: none (chip_smoke's contracts phase holds
# one decode step measured on the card to this).
STEP_SYNCS = 0

# Functions that take a decode position ``length`` (the KV-cache write
# ``k_cache[:, length]`` of ``models/attention.py::decode_attention``):
# name -> (index of ``length`` among the positional arguments, keyword).
# A tensor there makes the cache write a host sync (and fails on ``meta``).
LENGTH_CALLS: dict[str, tuple[int, str]] = {
    "decode_attention": (3, "length"),
    "decode_step": (2, "length"),  # model.decode_step(token, state, length)
    "_attn_decode_body": (3, "length"),
    "serve_step": (3, "length"),  # serve_step(model, token, state, length)
    "attention_block": (-1, "cache_length"),
}

# ---------------------------------------------------------------------------
# Rule scoping
# ---------------------------------------------------------------------------

# dispatch-triad applies to these modules' PUBLIC functions that take a
# keyword-only `backend` argument.
TRIAD_MODULES = ("repro_torch/kernels/ops.py",)

# f64-cast applies module-wide in kernels/ and inside step scopes elsewhere.
# The host numpy planners (core/placement.py, core/cost_model.py) are not
# step scopes: their float64 numpy is exempt, as in the reference.
F64_MODULE_WIDE = ("repro_torch/kernels/",)

# kernel-confined: outside kernels/, the kernels package is imported only
# through these modules; the CUDA wrapper modules, the builder and ctypes
# stay inside kernels/.
KERNELS_PACKAGE = "repro_torch.kernels"
BLESSED_KERNEL_IMPORTS = frozenset({"ops", "ref"})
RAW_KERNEL_MODULES = frozenset({"pairdist", "mapassign", "histogram", "compact", "_build"})
CONFINED_IMPORTS = frozenset({"ctypes"})

# layering: import roots no module of the port may name.
FORBIDDEN_IMPORTS = frozenset({"jax", "jaxlib", "repro"})

# collective-site: torch.distributed collectives and where each is blessed,
# as (file suffix, qualname); closures inside a listed function are covered.
# Anything not listed has NO blessed site.
COLLECTIVE_PRIMS = frozenset(
    {
        "all_to_all", "all_to_all_single", "all_gather", "all_gather_into_tensor",
        "all_gather_object", "all_reduce", "all_reduce_coalesced", "reduce",
        "reduce_scatter", "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
        "scatter", "scatter_object_list", "gather", "gather_object", "send", "recv",
        "isend", "irecv", "batch_isend_irecv", "barrier", "monitored_barrier",
    }
)
BLESSED_COLLECTIVE_SITES: dict[str, frozenset[tuple[str, str]]] = {
    # THE shuffle: one all_to_all_single per dispatch buffer, built in one
    # factory shared by the verify and serve stages.
    "all_to_all_single": frozenset({("repro_torch/core/distributed.py", "_make_exchange")}),
    # The stats/counts packets and the result gather of the executor; the
    # mesh path's parameter gathers.
    "all_gather": frozenset(
        {
            ("repro_torch/core/distributed.py", "_all_gather"),
            ("repro_torch/models/collectives.py", "gather_full"),
        }
    ),
    # The mesh path's one all-reduce (reduce_sum, copy_to's and
    # LayerGather's backward, the optimizer's per-leaf reductions).
    "all_reduce": frozenset({("repro_torch/models/collectives.py", "_all_reduce")}),
    # The mesh step's bucketed gather: one per layer and mesh dim, over
    # the layer's leaves flattened (LayerGather's forward).
    "all_gather_into_tensor": frozenset({("repro_torch/models/collectives.py", "_all_gather_rows")}),
    # The mesh step's gradients to the shards: one per layer and batch
    # mesh dim that shards its leaves (LayerGather's backward).
    "reduce_scatter_tensor": frozenset({("repro_torch/models/collectives.py", "_reduce_scatter")}),
}

# ---------------------------------------------------------------------------
# Host-sync constructs
# ---------------------------------------------------------------------------

# Tensor methods that read the device: flagged unless the receiver is known
# to be host data (a numpy array's .tolist() is not a sync).
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# torch.* calls that always block the host.
SYNC_TORCH_FUNCS = frozenset({"synchronize"})
# Calls whose output shape depends on the data: a sync unless a static
# ``size=`` is given.
DATA_SHAPE_FUNCS = frozenset({"nonzero", "masked_select", "unique", "unique_consecutive"})
# Factories that copy host data to the device when given ``device=``.
H2D_FACTORIES = frozenset({"as_tensor", "tensor"})

# ---------------------------------------------------------------------------
# Waiver ratchet
# ---------------------------------------------------------------------------

# Maximum number of `# spjoin-lint-torch: allow[...]` waivers across the
# linted tree. A RATCHET equal to the number shipped today: adding a waiver
# without removing one fails the check.
MAX_WAIVERS = 2

# Minimum justification length (characters after `--`) for a waiver.
MIN_JUSTIFICATION = 10
