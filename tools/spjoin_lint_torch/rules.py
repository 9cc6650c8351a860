"""The AST rules. Each takes a ModuleIndex and yields Violations.

  host-sync        device reads in hot scopes: ``.item()`` / ``.tolist()`` /
                   ``.cpu()`` / ``.numpy()`` on a value not known to be host
                   data, ``synchronize``, ``nonzero`` (and the other
                   data-shaped ops) without ``size=``, ``int()`` /
                   ``float()`` / ``bool()`` (or an ``if``/``while``/``assert``)
                   on a tensor, ``np.asarray`` of a tensor, an index by a
                   boolean mask, a host-to-device copy of host data. Step
                   tier: every site flagged. Stream tier: the sites in loop
                   bodies are counted, and the count must equal the scope's
                   budget. Anywhere: a tensor passed as a decode ``length``.
  dispatch-triad   every public ``backend=`` op in kernels/ops.py reaches a
                   ref.py oracle, a CUDA wrapper module and
                   ``resolve_backend`` (directly or through same-module
                   delegation).
  f64-cast         no float64 in kernels/ or in step scopes.
  collective-site  torch.distributed collectives only at the blessed sites.
  kernel-confined  outside kernels/, the kernels package only through
                   ``ops``/``ref``; ``ctypes`` and ``_build`` only in kernels/.
  layering         no ``jax`` / ``jaxlib`` / ``repro`` import.
"""
from __future__ import annotations

import ast

from spjoin_lint_torch import config
from spjoin_lint_torch.astlint import (
    HOST,
    MASK,
    TENSORISH,
    FuncInfo,
    ModuleIndex,
    Violation,
    _dotted,
    _root_name,
    scope_walk,
)

_CONVERT_BUILTINS = frozenset({"int", "float", "bool", "complex"})


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------


def _is_device_arg(node: ast.AST) -> bool:
    """A positional ``.to(...)`` argument that plainly names a device (a
    string, ``x.device``, a name with "dev" in it, ``torch.device(...)``),
    not a dtype."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value != "cpu"
    if isinstance(node, ast.Attribute):
        return node.attr == "device"
    if isinstance(node, ast.Name):
        return "dev" in node.id
    return isinstance(node, ast.Call) and _dotted(node.func) in ("torch.device", "device")


def _device_kw(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _to_cpu(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def sync_message(idx: ModuleIndex, node: ast.AST, fi: FuncInfo | None) -> str | None:
    """Why ``node`` makes the host wait on the card, or None."""
    if isinstance(node, ast.Subscript):
        sl = node.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        if any(idx.expr_kind(p, fi) == MASK for p in parts):
            return "an index by a boolean mask selects a data-dependent number of elements"
        return None
    if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
        if idx.expr_kind(node.test, fi) in TENSORISH:
            return "the Python truth value of a tensor reads it"
        return None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        if idx.expr_kind(node.operand, fi) in TENSORISH:
            return "`not` on a tensor reads it"
        return None
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    sized = any(kw.arg == "size" for kw in node.keywords)
    if isinstance(f, ast.Name):
        if f.id in _CONVERT_BUILTINS and node.args and idx.expr_kind(node.args[0], fi) in TENSORISH:
            return f"{f.id}() on a tensor reads it"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    root = _root_name(f)
    torch_call = idx._torch_name(root) and isinstance(f.value, ast.Name)
    if f.attr == "synchronize" and not idx.is_dist_alias(root):
        return f"{_dotted(f) or '.synchronize'}() blocks on the card"
    if torch_call:
        if f.attr in config.DATA_SHAPE_FUNCS and not sized:
            return f"torch.{f.attr}() has a data-dependent shape (no size=)"
        if f.attr == "where" and len(node.args) == 1 and not node.keywords:
            return "torch.where(cond) is nonzero: a data-dependent shape"
        if f.attr in config.H2D_FACTORIES and node.args:
            dev = _device_kw(node)
            if dev is not None and not _to_cpu(dev) and idx.expr_kind(node.args[0], fi) == HOST:
                return f"torch.{f.attr}(host data, device=...) is a host-to-device copy"
        return None
    if idx._np_name(root):
        if f.attr in ("asarray", "array") and node.args and idx.expr_kind(node.args[0], fi) in TENSORISH:
            return f"np.{f.attr}() of a tensor copies it to the host"
        return None
    recv = idx.expr_kind(f.value, fi)
    if f.attr in config.SYNC_METHODS and recv != HOST:
        return f".{f.attr}() reads the device"
    if f.attr in config.DATA_SHAPE_FUNCS and recv in TENSORISH and not sized:
        return f".{f.attr}() has a data-dependent shape (no size=)"
    if f.attr == "repeat_interleave" and recv in TENSORISH and node.args and \
            idx.expr_kind(node.args[0], fi) in TENSORISH:
        return ".repeat_interleave() by a tensor of counts has a data-dependent shape"
    if recv == HOST and (f.attr == "cuda" or (f.attr == "to" and (
            (_device_kw(node) is not None and not _to_cpu(_device_kw(node)))
            or any(_is_device_arg(a) for a in node.args)))):
        return f".{f.attr}() of host data is a host-to-device copy"
    return None


def _sync_sites(idx: ModuleIndex, nodes, fi: FuncInfo):
    seen: set[int] = set()
    for node in nodes:
        if id(node) in seen:
            continue
        seen.add(id(node))
        msg = sync_message(idx, node, fi)
        if msg:
            yield node, msg


def _loop_parts(node: ast.AST):
    """The parts of a ``for``/``while`` loop that run once per iteration
    (comprehensions inside them run there too)."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        return [*node.body, *node.orelse]
    if isinstance(node, ast.While):
        return [node.test, *node.body, *node.orelse]
    return []


def _walk_no_defs(nodes):
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def loop_sync_sites(idx: ModuleIndex, fi: FuncInfo):
    """(node, message) of every sync site inside a loop body of ``fi``."""
    inner = [n for part in (_loop_parts(n) for n in scope_walk(fi.node)) for n in part]
    yield from _sync_sites(idx, _walk_no_defs(inner), fi)


def _length_arg(idx: ModuleIndex, call: ast.Call, fi: FuncInfo | None) -> ast.AST | None:
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else None
    if name not in config.LENGTH_CALLS:
        return None
    pos, kw = config.LENGTH_CALLS[name]
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    if isinstance(f, ast.Name):  # a function of this module: its own signature
        callee = idx._resolve(f.id, fi)
        if callee is not None:
            names = [a.arg for a in callee.node.args.posonlyargs + callee.node.args.args]
            pos = names.index(kw) if kw in names else -1
    return call.args[pos] if 0 <= pos < len(call.args) else None


def check_host_sync(idx: ModuleIndex):
    for fi in idx.functions.values():
        if fi.tier == "step":
            for node, msg in _sync_sites(idx, scope_walk(fi.node), fi):
                yield Violation(idx.relpath, node.lineno, "host-sync",
                                f"{msg}, inside step scope `{fi.qualname}`")
        elif fi.tier == "stream":
            sites = list(loop_sync_sites(idx, fi))
            budget = idx.stream_budget(fi)
            if len(sites) != budget:
                where = ", ".join(f"{n.lineno} `{ast.unparse(n)[:40]}`" for n, _ in
                                  sorted(sites, key=lambda s: s[0].lineno)) or "none"
                verb = "exceed" if len(sites) > budget else "fall below"
                yield Violation(
                    idx.relpath, fi.node.lineno, "host-sync",
                    f"{len(sites)} sync site(s) in the loops of stream scope `{fi.qualname}` {verb} "
                    f"its budget of {budget} (config.STREAM_SCOPES; lines {where})")
    # A tensor decode position makes the KV-cache write a host sync.
    scopes = [(None, idx.tree)] + [(fi, fi.node) for fi in idx.functions.values()]
    for fi, root in scopes:
        nodes = root.body if fi is None else scope_walk(root)
        for node in (_walk_no_defs(nodes) if fi is None else nodes):
            if isinstance(node, ast.Call):
                arg = _length_arg(idx, node, fi)
                if arg is not None and idx.expr_kind(arg, fi) in TENSORISH:
                    yield Violation(
                        idx.relpath, node.lineno, "host-sync",
                        "a tensor decode `length` makes the cache write `k_cache[:, length]` "
                        "(models/attention.py::decode_attention) a host sync: pass an int")


# ---------------------------------------------------------------------------
# dispatch-triad
# ---------------------------------------------------------------------------


def _kernel_aliases(tree: ast.Module) -> tuple[set, set]:
    """(ref aliases, CUDA wrapper-module aliases) from the imports."""
    ref_alias, kern_alias = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == config.KERNELS_PACKAGE:
            for a in node.names:
                if a.name == "ref":
                    ref_alias.add(a.asname or a.name)
                elif a.name in config.RAW_KERNEL_MODULES:
                    kern_alias.add(a.asname or a.name)
    return ref_alias, kern_alias


def check_dispatch_triad(idx: ModuleIndex):
    if not any(idx.relpath.endswith(m) for m in config.TRIAD_MODULES):
        return
    ref_alias, kern_alias = _kernel_aliases(idx.tree)
    defs = {name: fi.node for name, fi in idx.module_scope.items()}
    effects: dict[str, set] = {}
    calls: dict[str, set] = {}
    for name, fn in defs.items():
        eff, callees = set(), set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                root = _root_name(f)
                if root in ref_alias:
                    eff.add("ref")
                elif root in kern_alias:
                    eff.add("cuda")
                elif f.attr == "resolve_backend":
                    eff.add("dispatch")
            elif isinstance(f, ast.Name):
                if f.id == "resolve_backend":
                    eff.add("dispatch")
                elif f.id in defs:
                    callees.add(f.id)
        effects[name] = eff
        calls[name] = callees
    changed = True  # same-module delegation closes the triad (pairdist_count -> pairdist_mask)
    while changed:
        changed = False
        for name in defs:
            for callee in calls[name]:
                merged = effects[name] | effects[callee]
                if merged != effects[name]:
                    effects[name] = merged
                    changed = True
    legs = {
        "ref": "a ref.py oracle call (the torch backend, the plain version)",
        "cuda": "a CUDA wrapper-module call (the kernel)",
        "dispatch": "a resolve_backend() dispatch",
    }
    for name, fn in defs.items():
        if name.startswith("_") or "backend" not in {a.arg for a in fn.args.kwonlyargs}:
            continue
        for leg in ("ref", "cuda", "dispatch"):
            if leg not in effects[name]:
                yield Violation(
                    idx.relpath, fn.lineno, "dispatch-triad",
                    f"public op `{name}` takes backend= but never reaches {legs[leg]} "
                    f"(directly or via same-module delegation)")


# ---------------------------------------------------------------------------
# f64-cast
# ---------------------------------------------------------------------------


def _f64_violations(idx: ModuleIndex, nodes, where: str):
    for node in nodes:
        if isinstance(node, ast.Attribute) and node.attr in ("float64", "double") and (
                idx._torch_name(_root_name(node)) or idx._np_name(_root_name(node))):
            yield Violation(idx.relpath, node.lineno, "f64-cast",
                            f"{_dotted(node)} in {where}: the port's kernel and step paths are fp32")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "double" and not node.args:
                yield Violation(idx.relpath, node.lineno, "f64-cast",
                                f".double() in {where} casts to float64")
            if isinstance(f, ast.Attribute) and f.attr in ("astype", "to", "type") and node.args:
                a = node.args[0]
                if (isinstance(a, ast.Name) and a.id == "float") or (
                        isinstance(a, ast.Constant) and a.value in ("float64", "double")):
                    yield Violation(idx.relpath, node.lineno, "f64-cast",
                                    f".{f.attr}({ast.unparse(a)}) in {where} promotes to float64")
            for kw in node.keywords:
                if kw.arg == "dtype" and isinstance(kw.value, ast.Name) and kw.value.id == "float":
                    yield Violation(idx.relpath, node.lineno, "f64-cast",
                                    f"dtype=float in {where} is float64: spell the fp32 dtype")


def check_f64_cast(idx: ModuleIndex):
    if any(root in idx.relpath for root in config.F64_MODULE_WIDE):
        yield from _f64_violations(idx, ast.walk(idx.tree), "a kernel module")
        return
    for fi in idx.functions.values():
        if fi.tier == "step":
            yield from _f64_violations(idx, scope_walk(fi.node), f"step scope `{fi.qualname}`")


# ---------------------------------------------------------------------------
# collective-site
# ---------------------------------------------------------------------------


def _collective_name(idx: ModuleIndex, call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in config.COLLECTIVE_PRIMS:
        if idx.is_dist_alias(_root_name(f)) and isinstance(f.value, ast.Name):
            return f.attr
        if (_dotted(f) or "").endswith(f"distributed.{f.attr}") and idx._torch_name(_root_name(f)):
            return f.attr
    if isinstance(f, ast.Name) and f.id in idx.imported_names:
        mod, name = idx.imported_names[f.id]
        if mod == "torch.distributed" and name in config.COLLECTIVE_PRIMS:
            return name
    return None


def check_collective_site(idx: ModuleIndex):
    hits = []

    def visit(node: ast.AST, top: str) -> None:
        for child in ast.iter_child_nodes(node):
            t = top
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) and top == "<module>":
                t = idx.func_of(child).qualname.split(".")[0]  # closures count as their factory
            if isinstance(child, ast.Call):
                name = _collective_name(idx, child)
                if name is not None:
                    blessed = config.BLESSED_COLLECTIVE_SITES.get(name, frozenset())
                    if not any(idx.relpath.endswith(s) and t == q for s, q in blessed):
                        sites = " / ".join(f"{s}::{q}" for s, q in sorted(blessed)) or \
                            "none: this collective has no blessed site"
                        hits.append(Violation(
                            idx.relpath, child.lineno, "collective-site",
                            f"torch.distributed.{name} outside its blessed site(s): {sites}. A new "
                            f"collective changes the stage and step budgets the audit holds"))
            visit(child, t)

    visit(idx.tree, "<module>")
    yield from hits


# ---------------------------------------------------------------------------
# kernel-confined
# ---------------------------------------------------------------------------


def check_kernel_confined(idx: ModuleIndex):
    if "repro_torch/kernels/" in idx.relpath:
        return
    pkg = config.KERNELS_PACKAGE
    for node in ast.walk(idx.tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mod = node.module
            if mod == pkg:
                for a in node.names:
                    if a.name not in config.BLESSED_KERNEL_IMPORTS:
                        yield Violation(
                            idx.relpath, node.lineno, "kernel-confined",
                            f"imports `{pkg}.{a.name}`: outside kernels/ the kernels package is "
                            f"reached only through ops/ref (core -> ops -> CUDA wrappers)")
            elif mod.startswith(pkg + ".") and mod.split(".")[2] not in config.BLESSED_KERNEL_IMPORTS:
                yield Violation(idx.relpath, node.lineno, "kernel-confined",
                                f"imports from `{mod}`: go through ops/ref")
            if mod.split(".")[0] in config.CONFINED_IMPORTS:
                yield Violation(idx.relpath, node.lineno, "kernel-confined",
                                f"imports from `{mod}`: ctypes is the kernels' binding layer only")
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] in config.CONFINED_IMPORTS:
                    yield Violation(idx.relpath, node.lineno, "kernel-confined",
                                    f"imports `{a.name}`: ctypes is the kernels' binding layer only")
                elif a.name.startswith(pkg + ".") and parts[2] not in config.BLESSED_KERNEL_IMPORTS:
                    yield Violation(idx.relpath, node.lineno, "kernel-confined",
                                    f"imports `{a.name}`: go through ops/ref")


# ---------------------------------------------------------------------------
# layering
# ---------------------------------------------------------------------------


def check_layering(idx: ModuleIndex):
    for node in ast.walk(idx.tree):
        roots = []
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots = [node.module.split(".")[0]]
        for r in roots:
            if r in config.FORBIDDEN_IMPORTS:
                yield Violation(idx.relpath, node.lineno, "layering",
                                f"imports `{r}`: the port imports neither JAX nor the JAX package")


ALL_RULES = (
    check_host_sync,
    check_dispatch_triad,
    check_f64_cast,
    check_collective_site,
    check_kernel_confined,
    check_layering,
)
