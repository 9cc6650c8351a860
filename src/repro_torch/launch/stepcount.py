"""One step's account, taken by running it once on ``meta`` tensors: what a
rank of the mesh computes, moves and holds. It stands where the reference's
dry run reads XLA's compiled module (``memory_analysis`` and
``hloparse.analyze``); here nothing is compiled, every op is dispatched and
recorded as it runs, and no byte is allocated.

``count_step(fn, held)`` runs ``fn()`` once and returns, for this rank:

  flops        ``torch.utils.flop_counter``'s formulas (matmul, batched
               matmul, convolution), as ``FlopCounterMode`` totals them. The port
               has no scan: every layer, microbatch and remat recompute is
               executed, so each is counted as many times as it runs.
  dot_traffic  the bytes of the two operands and the result of every
               ``mm``/``addmm``/``bmm``/``baddbmm`` (an ``addmm``'s bias
               left out, as an HLO ``dot`` has none): the reference's
               memory-term numerator.
  collectives  counts and wire bytes per rank by kind
               (``collectives.collective_counts`` / ``collective_bytes``).
  memory       the peak of the bytes of live storages, the ``held`` tensors
               included, and its split at the peak by kind:
                 the kinds of ``held`` (parameters, optimizer state, inputs);
                 activations — made in a module's forward (the gathered
                   whole leaves among them) or, outside the backward pass,
                   while autograd records (the loss): what the backward
                   pass keeps, and what the forward makes and drops;
                 gradients — made in a backward pass and still alive when
                   it ends (what ``autograd.grad`` returns), and, in a step
                   that runs a backward pass, what the step makes outside
                   both with autograd off (the microbatch accumulators, the
                   optimizer's per-leaf temporaries: run a train step
                   under ``torch.no_grad()``, it records its own forward);
                 temporaries — made in a backward pass and freed within it
                   (remat's recompute, the gradient arithmetic).
               In a step with no backward pass (prefill, decode) everything
               it makes counts as activations. A storage counts once
               whatever views it has; the caching allocator's rounding and
               the libraries' workspaces are not seen.
"""
from __future__ import annotations

import itertools
import weakref

import torch
from torch.nn.modules.module import register_module_forward_hook, register_module_forward_pre_hook
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.models import collectives

_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}
_BIASED = {torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}
MEMORY_KINDS = ("parameters", "optimizer", "inputs", "activations", "gradients", "temporaries")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(x):
    """A hashable key of an op argument's metadata; ``TypeError`` where it
    has none (a tensor off the ``meta`` device, an object)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not a meta tensor")
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, *(_key(v) for v in x))
    if isinstance(x, dict):
        return ("D", *((k, _key(v)) for k, v in sorted(x.items())))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device, torch.layout,
                                   torch.memory_format)):
        return x
    raise TypeError(f"no key for {type(x).__name__}")


class _Recorder(TorchDispatchMode):
    """One mode for the whole account (a mode per recorder would cost a
    dispatch layer each on every op):

    - FLOPs by ``torch.utils.flop_counter``'s formulas, as
      ``FlopCounterMode`` counts them;
    - dot traffic;
    - the life of every storage, in op order: its creation index, kind and
      bytes, and, when it dies, its free index (a ``weakref.finalize`` on
      the storage);
    - the meta kernels' results memoized by their inputs' metadata. A meta
      kernel computes only shapes, strides and dtypes, many are Python
      decompositions that cost far more than this bookkeeping, and the step
      repeats the same ops on the same shapes layer after layer. Only ops
      that mutate nothing and return fresh tensors are memoized (views,
      in-place ops and collectives run); a hit returns new ``meta`` tensors
      of the recorded layout, and is counted like a run."""

    def __init__(self, held: dict[str, list[torch.Tensor]]):
        super().__init__()
        self.t = 0  # ops dispatched so far
        self.flops = 0
        self.dot_traffic = 0
        self.live = 0
        self.peak, self.t_peak = 0, 0
        self.serial_of: dict[int, int] = {}  # live storage -> its serial
        self.rows: list[list] = []  # per serial: [bytes, kind, created, freed or None, backward pass]
        self.backward: list[list[int]] = []  # per backward pass: [start, end or None]
        self.ids = itertools.count()
        self.cache: dict = {}
        self.in_module = 0  # depth of module forwards (``count_step``'s hooks)
        for kind, tensors in held.items():
            for x in tensors:
                self._track(x, kind)
        self._mark_peak()

    def _track(self, x: torch.Tensor, kind: str) -> None:
        st = x.untyped_storage()
        key = st._cdata
        if key in self.serial_of:
            return
        serial = next(self.ids)
        self.serial_of[key] = serial
        n = st.nbytes()
        self.rows.append([n, kind, self.t, None, len(self.backward) - 1 if kind == "backward" else None])
        self.live += n
        weakref.finalize(st, self._free, key, serial)

    def _free(self, key: int, serial: int) -> None:
        if self.serial_of.get(key) == serial:
            del self.serial_of[key]
        row = self.rows[serial]
        if row[3] is None:
            row[3] = self.t
            self.live -= row[0]

    def _mark_peak(self) -> None:
        if self.live > self.peak:
            self.peak, self.t_peak = self.live, self.t

    def _run(self, func, args, kwargs):
        schema = func._schema
        if schema.is_mutable or any(r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        hit = self.cache.get(key)
        if hit is not None:
            layouts, spec = hit
            return tree_unflatten([torch.empty_strided(size, stride, dtype=dtype, device="meta")
                                   for size, stride, dtype in layouts], spec)
        out = func(*args, **kwargs)
        flat, spec = tree_flatten(out)
        if all(isinstance(x, torch.Tensor) and x.device.type == "meta" for x in flat):
            self.cache[key] = ([(tuple(x.shape), x.stride(), x.dtype) for x in flat], spec)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        in_backward = torch._C._current_graph_task_id() != -1
        if in_backward and (not self.backward or self.backward[-1][1] is not None):
            self.backward.append([self.t, None])
        elif not in_backward and self.backward and self.backward[-1][1] is None:
            self.backward[-1][1] = self.t
        out = self._run(func, args, kwargs)
        self.t += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func in _DOTS:
            a, b = args[1:3] if func in _BIASED else args[:2]
            self.dot_traffic += _nbytes(a) + _nbytes(b) + _nbytes(out)
        if in_backward:
            kind = "backward"
        else:  # a module's forward (its custom functions run with autograd off), or the loss
            kind = "forward" if self.in_module or torch.is_grad_enabled() else "no_grad"
        for x in tree_flatten(out)[0]:
            if isinstance(x, torch.Tensor):
                self._track(x, kind)
        self._mark_peak()
        return out

    def split_at_peak(self) -> dict[str, int]:
        """The live bytes at the peak by kind (``MEMORY_KINDS``)."""
        out = dict.fromkeys(MEMORY_KINDS, 0)
        ran_backward = bool(self.backward)
        for n, kind, made, freed, bwd in self.rows:
            if made > self.t_peak or (freed is not None and freed < self.t_peak):
                continue
            if kind == "forward":
                kind = "activations"
            elif kind == "no_grad":
                kind = "gradients" if ran_backward else "activations"
            elif kind == "backward":
                end = self.backward[bwd][1]
                kept = freed is None or (end is not None and freed > end)
                kind = "gradients" if kept else "temporaries"
            out[kind] += n
        return out


def count_step(fn, held: dict[str, list[torch.Tensor]]) -> tuple[object, dict]:
    """Run ``fn()`` once and account for it (module docstring): ``held``
    maps a kind to the tensors that are alive before the step and part of
    its arguments. Returns (``fn``'s result, the account)."""
    collectives.reset_collective_counts()
    recorder = _Recorder(held)

    def enter(module, args):
        recorder.in_module += 1

    def leave(module, args, out):
        recorder.in_module -= 1

    hooks = [register_module_forward_pre_hook(enter), register_module_forward_hook(leave, always_call=True)]
    try:
        with recorder:
            result = fn()
    finally:
        for h in hooks:
            h.remove()
    return result, {
        "flops": float(recorder.flops),
        "dot_traffic": float(recorder.dot_traffic),
        "coll_counts": collectives.collective_counts(),
        "coll_bytes": collectives.collective_bytes(),
        "peak_bytes": recorder.peak,
        "memory_split": recorder.split_at_peak(),
    }
