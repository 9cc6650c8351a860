"""Scope machinery, value kinds and the driver of the AST layer.

The port runs eagerly, so nothing in its source says where it is hot the
way ``jax.jit`` does in the reference: the tiers come from ``config``
(``STREAM_SCOPES``, ``STEP_SCOPES``), and a step scope's same-module
callees join it, iterated to a fixpoint, as the reference's traced tier
does.

Whether ``int(x)`` or ``x[m]`` reads the device depends on what ``x`` and
``m`` hold, which Python does not write down. Each function gets a small,
flow-insensitive inference of its names' KINDS:

  "host"    Python and numpy values, and CPU tensors made from them
            (``.cpu()``, ``torch.from_numpy``, ``torch.as_tensor`` without a
            device): reading them costs no sync;
  "tensor"  a tensor that may live on the card;
  "mask"    a boolean tensor (a comparison, ``&``/``|``/``~`` of masks, a
            function that returns one): indexing with it selects a
            data-dependent number of elements, which is a sync.

Kinds come from literals, ``torch.*``/``np.*`` calls, methods on values of
known kind, parameter and return annotations (``Tensor``, ``np.ndarray``,
``int``, ...), and the return statements of the functions a call reaches,
in this module or, through its imports, in another module of the package.
A name that any assignment makes a tensor is a tensor. What cannot be
resolved is unknown, and the rules do not flag an unknown value: the
checker under-reports rather than invent syncs, and chip_smoke's
``contracts`` phase holds what it counts against what the card measures.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib

from spjoin_lint_torch import config

HOST, TENSOR, MASK = "host", "tensor", "mask"
TENSORISH = (TENSOR, MASK)

_TENSOR_ANN = frozenset({"Tensor"})
_HOST_ANN = frozenset(
    {"int", "float", "bool", "str", "bytes", "None", "ndarray", "Callable", "dtype", "device",
     "Generator"}
)
_SCALAR_ANN = frozenset({"int", "float", "bool"})
_TORCH_HOST_FUNCS = frozenset(
    {"device", "Size", "finfo", "iinfo", "is_tensor", "is_grad_enabled", "get_default_dtype",
     "no_grad", "enable_grad", "inference_mode", "Generator", "is_floating_point", "numel",
     "from_numpy", "manual_seed", "set_grad_enabled"}
)
_TORCH_MASK_FUNCS = frozenset(
    {"isfinite", "isnan", "isinf", "isneginf", "isposinf", "eq", "ne", "lt", "le", "gt", "ge",
     "logical_and", "logical_or", "logical_not", "logical_xor", "isclose", "isin"}
)
_HOST_METHODS = frozenset(
    {"numel", "dim", "size", "element_size", "nelement", "stride", "is_contiguous", "data_ptr",
     "get_device", "item", "tolist", "numpy", "cpu", "is_floating_point", "storage_offset",
     "keys", "values", "items", "get", "count", "index", "startswith", "endswith", "format",
     "split", "join", "strip", "get_world_size", "get_rank"}
)
_MASK_METHODS = frozenset(
    {"bool", "isnan", "isinf", "isfinite", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
     "logical_or", "logical_not", "logical_xor", "any", "all", "isclose"}
)
_HOST_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad", "size", "itemsize",
     "nbytes", "layout", "is_leaf"}
)
_SAME_KIND_ATTRS = frozenset({"T", "mT", "H", "mH", "real", "imag", "grad", "data"})
_HOST_BUILTINS = frozenset(
    {"len", "range", "int", "float", "bool", "str", "isinstance", "enumerate", "zip", "sorted",
     "list", "tuple", "dict", "set", "frozenset", "repr", "hash", "id", "type", "round",
     "divmod", "hasattr", "getattr", "callable", "print", "iter", "next", "reversed", "map",
     "filter", "any", "all"}
)


def join_kinds(kinds) -> str | None:
    """The kind of a value that may be any of ``kinds``: a tensor when any
    may be one (a mask when all tensor kinds are masks), host when all
    are host, else unknown."""
    kinds = list(kinds)
    tens = [k for k in kinds if k in TENSORISH]
    if tens:
        return MASK if all(k == MASK for k in tens) else TENSOR
    if kinds and all(k == HOST for k in kinds):
        return HOST
    return None


@dataclasses.dataclass
class Violation:
    file: str
    line: int
    rule: str
    message: str
    waived: bool = False

    def format(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}{tag}"


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str
    parent: "FuncInfo | None"
    tier: str | None = None  # "step" | "stream" | None
    children: dict = dataclasses.field(default_factory=dict)  # name -> FuncInfo
    env: dict | None = None  # name -> kind (set lazily)
    returns: object = None  # kind, or a tuple of kinds (set lazily)


def _root_name(node: ast.AST) -> str | None:
    """Leftmost Name of a dotted attribute chain (``torch.cuda.x`` -> torch)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.AST) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _ann_names(ann: ast.AST | None) -> set[str]:
    if ann is None:
        return set()
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return set()
    out = set()
    for n in ast.walk(ann):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Constant) and n.value is None:
            out.add("None")
    return out


def kind_of_annotation(ann: ast.AST | None):
    """A parameter's or return's kind from its annotation; a tuple of kinds
    for ``tuple[A, B]``."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if (isinstance(ann, ast.Subscript) and _dotted(ann.value) in ("tuple", "Tuple")
            and isinstance(ann.slice, ast.Tuple)
            and not any(isinstance(e, ast.Constant) and e.value is Ellipsis for e in ann.slice.elts)):
        return tuple(kind_of_annotation(e) for e in ann.slice.elts)
    names = _ann_names(ann)
    if names & _TENSOR_ANN:
        # `int | Tensor` may be either: unknown; `Tensor | None` is a tensor
        return None if names & _SCALAR_ANN else TENSOR
    if names and names <= (_HOST_ANN | {"Optional", "Union", "np", "numpy", "torch", "typing"}):
        return HOST
    return None


class Project:
    """The modules of the linted package, parsed once, for resolving a
    call's return kind across modules (``from repro_torch.kernels import
    ref`` then ``ref.emit_keep(...)``)."""

    def __init__(self):
        self._modules: dict[str, "ModuleIndex | None"] = {}

    def module(self, path: pathlib.Path) -> "ModuleIndex | None":
        key = path.as_posix()
        if key not in self._modules:
            self._modules[key] = None  # recursion guard
            if path.is_file():
                tree = ast.parse(path.read_text(), filename=key)
                self._modules[key] = ModuleIndex(tree, key, self)
        return self._modules[key]


class ModuleIndex:
    """Per-file scope index: functions, tiers, imports, value kinds."""

    def __init__(self, tree: ast.Module, relpath: str, project: Project | None = None):
        self.tree = tree
        self.relpath = relpath
        self.project = project or Project()
        self.functions: dict[str, FuncInfo] = {}
        self._by_node: dict[int, FuncInfo] = {}
        self.module_scope: dict[str, FuncInfo] = {}
        self.classes: dict[str, dict[str, FuncInfo]] = {}
        self.module_aliases: dict[str, str] = {}  # local name -> dotted module
        self.imported_names: dict[str, tuple[str, str]] = {}  # local -> (module, name)
        self.module_kinds: dict[str, str | None] = {}
        self._build(tree)
        self._read_imports(tree)
        self._module_env(tree)
        self._apply_config()
        self._propagate_calls()

    # -- construction ------------------------------------------------------

    def _build(self, tree: ast.Module) -> None:
        def visit(node: ast.AST, parent: FuncInfo | None, prefix: str, cls: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    fi = FuncInfo(node=child, qualname=qual, parent=parent)
                    self.functions[qual] = fi
                    self._by_node[id(child)] = fi
                    if parent is None and cls is None:
                        self.module_scope[child.name] = fi
                    elif parent is None:
                        self.classes.setdefault(cls, {})[child.name] = fi
                    else:
                        parent.children[child.name] = fi
                    visit(child, fi, qual + ".", None)
                elif isinstance(child, ast.ClassDef):
                    visit(child, parent, f"{prefix}{child.name}.", child.name)
                else:
                    visit(child, parent, prefix, cls)

        visit(tree, None, "", None)

    def _read_imports(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.module_aliases[a.asname] = a.name
                    else:
                        self.module_aliases[a.name.split(".")[0]] = a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    local = a.asname or a.name
                    # `from pkg import mod` binds a module when pkg/mod.py exists;
                    # record both readings and let resolution decide.
                    self.module_aliases.setdefault(local, f"{node.module}.{a.name}")
                    self.imported_names[local] = (node.module, a.name)

    def _module_env(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.Assign):
                k = self.expr_kind(node.value, None)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_kinds[t.id] = k

    def func_of(self, node: ast.AST) -> FuncInfo | None:
        return self._by_node.get(id(node))

    # -- tiers ---------------------------------------------------------------

    def _resolve(self, name: str, scope: FuncInfo | None) -> FuncInfo | None:
        """Resolve a bare function name from a scope, innermost first."""
        s = scope
        while s is not None:
            if name in s.children:
                return s.children[name]
            s = s.parent
        return self.module_scope.get(name)

    def _mark(self, fi: FuncInfo, tier: str) -> None:
        stack = [fi]
        while stack:
            f = stack.pop()
            if f.tier is None:
                f.tier = tier
            stack.extend(f.children.values())

    def _apply_config(self) -> None:
        for suffix, quals in config.STEP_SCOPES.items():
            if self.relpath.endswith(suffix):
                for q in quals:
                    if q in self.functions:
                        self._mark(self.functions[q], "step")
        for suffix, budgets in config.STREAM_SCOPES.items():
            if self.relpath.endswith(suffix):
                for q in budgets:
                    if q in self.functions:
                        self.functions[q].tier = "stream"

    def _propagate_calls(self) -> None:
        """Same-module functions a step scope names (calls it makes, and
        bodies it hands on, as ``_remat(_moe_body, ...)``) join the step
        tier, to a fixpoint."""
        changed = True
        while changed:
            changed = False
            for fi in list(self.functions.values()):
                if fi.tier != "step":
                    continue
                for node in scope_walk(fi.node):
                    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                        callee = self._resolve(node.id, fi)
                        if callee is not None and callee.tier is None:
                            self._mark(callee, "step")
                            changed = True

    def stream_budget(self, fi: FuncInfo) -> int | None:
        for suffix, budgets in config.STREAM_SCOPES.items():
            if self.relpath.endswith(suffix) and fi.qualname in budgets:
                return budgets[fi.qualname]
        return None

    # -- kinds ---------------------------------------------------------------

    def env_of(self, fi: FuncInfo) -> dict:
        """{name: kind} of ``fi``'s parameters and assignments: the join of
        every binding's known kind (a binding of unknown kind adds
        nothing)."""
        if fi.env is not None:
            return fi.env
        fi.env = {}
        args = fi.node.args
        params: dict[str, list] = {}
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            params[a.arg] = [kind_of_annotation(a.annotation)]
        for a in (args.vararg, args.kwarg):
            if a is not None:
                params[a.arg] = [HOST]
        for _ in range(20):  # each pass carries kinds one assignment further: to a fixpoint
            found = {k: list(v) for k, v in params.items()}
            for node in scope_walk(fi.node):
                for target, kind in self._bindings(node, fi):
                    found.setdefault(target, []).append(kind)
            env = {k: join_kinds(x for x in v if x is not None) for k, v in found.items()}
            if env == fi.env:
                break
            fi.env = env
        return fi.env

    def _bindings(self, node: ast.AST, fi: FuncInfo):
        """(name, kind) pairs that ``node`` binds."""
        if isinstance(node, ast.Assign):
            for t in node.targets:
                yield from self._bind_target(t, node.value, fi)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            k = kind_of_annotation(node.annotation)
            if isinstance(node.target, ast.Name):
                yield node.target.id, k if k is not None else self.expr_kind(node.value, fi)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            yield node.target.id, self.expr_kind(node.value, fi)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            yield from self._bind_iter(node.target, node.iter, fi)
        elif isinstance(node, ast.comprehension):
            yield from self._bind_iter(node.target, node.iter, fi)
        elif isinstance(node, ast.NamedExpr) and isinstance(node.target, ast.Name):
            yield node.target.id, self.expr_kind(node.value, fi)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.optional_vars, ast.Name):
                    yield item.optional_vars.id, None

    def _bind_target(self, target: ast.AST, value: ast.AST, fi: FuncInfo):
        if isinstance(target, ast.Name):
            yield target.id, self.expr_kind(value, fi)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    yield from self._bind_target(t, v, fi)
                return
            kinds = self.call_returns(value, fi)
            for i, t in enumerate(target.elts):
                if not isinstance(t, ast.Name):
                    continue
                if isinstance(kinds, tuple) and i < len(kinds):
                    yield t.id, kinds[i]
                else:
                    yield t.id, self._element_kind(value, fi)

    def _element_kind(self, value: ast.AST, fi: FuncInfo) -> str | None:
        """The kind of each element unpacked from ``value``."""
        k = self.expr_kind(value, fi)
        if k in TENSORISH:
            return TENSOR  # rows of a tensor, or the tensors of a returned tuple
        if isinstance(value, ast.Call) and _dotted(value.func) in ("zip", "enumerate"):
            return None
        return k

    def _bind_iter(self, target: ast.AST, it: ast.AST, fi: FuncInfo):
        if isinstance(it, ast.Call) and _dotted(it.func) == "range":
            kind = HOST
        else:
            kind = self._element_kind(it, fi) if self.expr_kind(it, fi) in TENSORISH else None
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                yield n.id, kind

    def name_kind(self, name: str, fi: FuncInfo | None) -> str | None:
        s = fi
        while s is not None:
            env = self.env_of(s)
            if name in env:
                return env[name]
            s = s.parent
        if name in self.module_kinds:
            return self.module_kinds[name]
        return None

    def _torch_name(self, root: str | None) -> bool:
        return root is not None and self.module_aliases.get(root, "").split(".")[0] == "torch"

    def _np_name(self, root: str | None) -> bool:
        return root is not None and self.module_aliases.get(root, "").split(".")[0] in ("numpy", "math")

    def is_dist_alias(self, root: str | None) -> bool:
        return root is not None and self.module_aliases.get(root) == "torch.distributed"

    def expr_kind(self, node: ast.AST, fi: FuncInfo | None) -> str | None:
        """The kind of the value ``node`` evaluates to (None: unknown)."""
        if isinstance(node, (ast.Constant, ast.JoinedStr, ast.List, ast.Dict, ast.Set,
                             ast.ListComp, ast.DictComp, ast.SetComp, ast.GeneratorExp, ast.Lambda)):
            return HOST
        if isinstance(node, ast.Tuple):
            return join_kinds(self.expr_kind(e, fi) for e in node.elts) if node.elts else HOST
        if isinstance(node, ast.Name):
            return self.name_kind(node.id, fi)
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return HOST
            if node.attr in _SAME_KIND_ATTRS:
                return self.expr_kind(node.value, fi)
            if self._torch_name(_root_name(node)):
                return HOST  # torch.float32, torch.bool, ...
            if self._np_name(_root_name(node)):
                return HOST
            return None
        if isinstance(node, ast.Subscript):
            k = self.expr_kind(node.value, fi)
            return k if k in (HOST, MASK, TENSOR) else None
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return HOST  # identity and membership tests are Python bools
            kinds = [self.expr_kind(n, fi) for n in [node.left, *node.comparators]]
            if any(k in TENSORISH for k in kinds):
                return MASK
            return HOST if all(k == HOST for k in kinds) else None
        if isinstance(node, ast.BoolOp):
            return join_kinds(self.expr_kind(v, fi) for v in node.values)
        if isinstance(node, ast.BinOp):
            kinds = [self.expr_kind(node.left, fi), self.expr_kind(node.right, fi)]
            if isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)) and any(k in TENSORISH for k in kinds):
                return MASK if all(k in (MASK, HOST) for k in kinds) else TENSOR
            if any(k in TENSORISH for k in kinds):
                return TENSOR
            return HOST if all(k == HOST for k in kinds) else None
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return HOST
            return self.expr_kind(node.operand, fi)
        if isinstance(node, ast.IfExp):
            return join_kinds([self.expr_kind(node.body, fi), self.expr_kind(node.orelse, fi)])
        if isinstance(node, ast.Call):
            r = self.call_returns(node, fi)
            return join_kinds(r) if isinstance(r, tuple) else r
        return None

    def call_returns(self, node: ast.AST, fi: FuncInfo | None):
        """The kind (or tuple of kinds) a call returns."""
        if not isinstance(node, ast.Call):
            return self.expr_kind(node, fi) if not isinstance(node, (ast.Tuple, ast.List)) else None
        f = node.func
        root = _root_name(f)
        if isinstance(f, ast.Attribute):
            if self._torch_name(root):
                dotted = _dotted(f) or ""
                if ".cuda." in f".{dotted}." or ".distributed." in f".{dotted}.":
                    return HOST
                if f.attr in _TORCH_HOST_FUNCS:
                    return HOST
                if f.attr in _TORCH_MASK_FUNCS:
                    return MASK
                if f.attr in ("as_tensor", "tensor") and node.args and not _has_device(node):
                    if self.expr_kind(node.args[0], fi) == HOST:
                        return HOST  # a CPU tensor of host data
                if f.attr in ("zeros", "ones", "empty", "full") and _dtype_kw(node) == "bool":
                    return MASK
                return TENSOR
            if self._np_name(root) or self.is_dist_alias(root):
                return HOST
            if isinstance(f.value, ast.Name) and f.value.id in self.module_aliases and \
                    self.name_kind(f.value.id, fi) is None:
                r = self._cross_module_returns(self.module_aliases[f.value.id], f.attr)
                if r is not None:
                    return r
            recv = self.expr_kind(f.value, fi)
            if f.attr in _HOST_METHODS:
                return HOST
            if recv in TENSORISH:
                if f.attr in _MASK_METHODS:
                    return MASK
                if f.attr == "to" and _dtype_arg(node) == "bool":
                    return MASK
                return recv if f.attr in ("clone", "contiguous", "detach", "view", "reshape",
                                          "flatten", "squeeze", "unsqueeze", "transpose") else TENSOR
            if recv == HOST:
                return HOST
            if isinstance(f.value, ast.Name) and f.value.id == "self" and fi is not None:
                m = self._method(fi, f.attr)
                if m is not None:
                    return self.returns_of(m)
            return None
        if isinstance(f, ast.Name):
            if f.id in ("min", "max", "abs", "sum"):
                return join_kinds(self.expr_kind(a, fi) for a in node.args) if node.args else None
            if f.id in _HOST_BUILTINS:
                return HOST
            callee = self._resolve(f.id, fi)
            if callee is not None:
                return self.returns_of(callee)
            if f.id in self.imported_names:
                mod, name = self.imported_names[f.id]
                return self._cross_module_returns(mod, name)
        return None

    def _method(self, fi: FuncInfo, name: str) -> FuncInfo | None:
        cls = fi.qualname.split(".")[0]
        return self.classes.get(cls, {}).get(name)

    def _cross_module_returns(self, module: str, name: str):
        if not module.startswith(config.PACKAGE + ".") and module != config.PACKAGE:
            return None
        path = self._module_path(module)
        if path is None:
            return None
        other = self.project.module(path)
        if other is None or name not in other.module_scope:
            return None
        return other.returns_of(other.module_scope[name])

    def _module_path(self, module: str) -> pathlib.Path | None:
        """The file of ``module`` in the package tree this file lies in."""
        parts = pathlib.Path(self.relpath).parts
        if config.PACKAGE not in parts:
            return None
        at = len(parts) - 1 - parts[::-1].index(config.PACKAGE)
        path = pathlib.Path(*parts[:at], *module.split(".")).with_suffix(".py") if at else \
            pathlib.Path(*module.split(".")).with_suffix(".py")
        return path if path.is_file() else None

    def returns_of(self, fi: FuncInfo):
        """What ``fi`` returns: its annotation, refined to "mask" where every
        return statement gives a mask."""
        if fi.returns is not None:
            return None if fi.returns == "?" else fi.returns
        fi.returns = "?"  # recursion guard
        ann = kind_of_annotation(getattr(fi.node, "returns", None))
        rets = [n for n in scope_walk(fi.node) if isinstance(n, ast.Return) and n.value is not None]
        inferred = None
        if rets and not isinstance(ann, tuple):
            inferred = join_kinds(self.expr_kind(r.value, fi) for r in rets)
        if isinstance(ann, tuple):
            out = ann
        elif ann == TENSOR and inferred == MASK:
            out = MASK
        elif ann is not None:
            out = ann
        else:
            out = inferred
        fi.returns = out if out is not None else "?"
        return out


def _has_device(call: ast.Call) -> bool:
    return any(kw.arg == "device" for kw in call.keywords)


def _dtype_kw(call: ast.Call) -> str | None:
    for kw in call.keywords:
        if kw.arg == "dtype" and isinstance(kw.value, ast.Attribute):
            return kw.value.attr
    return None


def _dtype_arg(call: ast.Call) -> str | None:
    for a in call.args:
        if isinstance(a, ast.Attribute):
            return a.attr
    return _dtype_kw(call)


def scope_walk(func_node: ast.AST):
    """Walk a function body WITHOUT descending into nested function defs
    (each scope is checked once, under its own tier)."""
    stack = list(ast.iter_child_nodes(func_node))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def iter_lint_files(paths: list[str]) -> list[pathlib.Path]:
    """Expand CLI paths to the .py files in scope (config.LINT_ROOTS)."""
    out: list[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_file():
            out.append(path)
            continue
        for f in sorted(path.rglob("*.py")):
            if any(root in f.as_posix() for root in config.LINT_ROOTS):
                out.append(f)
    return out


def lint_file(path: pathlib.Path, project: Project | None = None) -> list[Violation]:
    """Lint one file: run every rule, apply waivers, check waiver hygiene
    (the global ratchet is ``lint_paths``')."""
    from spjoin_lint_torch import rules as rules_mod
    from spjoin_lint_torch import waivers as waivers_mod

    source = path.read_text()
    relpath = path.as_posix()
    project = project or Project()
    idx = project.module(path) or ModuleIndex(ast.parse(source, filename=relpath), relpath, project)

    violations: list[Violation] = []
    for rule in rules_mod.ALL_RULES:
        violations.extend(rule(idx))

    wvs = waivers_mod.parse_waivers(source, relpath)
    by_line = waivers_mod.waivers_by_target(wvs)
    for v in violations:
        for w in by_line.get(v.line, []):
            if v.rule in w.rules:
                v.waived = True
                w.used = True

    for w in wvs:
        unknown = [r for r in w.rules if r not in config.RULES]
        if unknown:
            violations.append(Violation(
                relpath, w.line, "waiver-hygiene",
                f"waiver names unknown rule(s) {unknown}; known rules: {list(config.RULES)}"))
        if len(w.justification) < config.MIN_JUSTIFICATION:
            violations.append(Violation(
                relpath, w.line, "waiver-hygiene",
                "waiver has no (or a trivial) justification: write `# spjoin-lint-torch: "
                "allow[rule] -- why this is sound here`"))
        if not w.used:
            violations.append(Violation(
                relpath, w.line, "waiver-hygiene",
                "unused waiver (suppresses nothing on its target line): remove it and lower "
                "config.MAX_WAIVERS"))
    violations = [v for v in violations if not v.waived]
    violations.sort(key=lambda v: (v.line, v.rule))
    return violations


def lint_paths(paths: list[str]) -> tuple[list[Violation], int]:
    """Lint every in-scope file under ``paths``. Returns (violations,
    n_waivers); more waivers than ``config.MAX_WAIVERS`` adds one
    waiver-hygiene violation."""
    from spjoin_lint_torch import waivers as waivers_mod

    violations: list[Violation] = []
    n_waivers = 0
    project = Project()
    for f in iter_lint_files(paths):
        violations.extend(lint_file(f, project))
        n_waivers += len(waivers_mod.parse_waivers(f.read_text(), f.as_posix()))
    if n_waivers > config.MAX_WAIVERS:
        violations.append(Violation(
            paths[0] if paths else ".", 0, "waiver-hygiene",
            f"{n_waivers} waivers in tree exceed the ratchet (MAX_WAIVERS={config.MAX_WAIVERS}). "
            f"The ratchet only moves down: fix the new violation for real, or make the case "
            f"for raising it in review"))
    return violations, n_waivers


def sync_sites(path: pathlib.Path) -> dict[str, dict]:
    """{stream scope qualname: {"sites": lines of the sync sites in its
    loops, "loops": (first, last) line of each outermost for/while loop}}
    of one file: what the stream-tier budgets count (chip_smoke's contracts
    phase holds the lines the card reports against these)."""
    from spjoin_lint_torch import rules as rules_mod

    idx = Project().module(path)
    out = {}
    for fi in idx.functions.values():
        if fi.tier != "stream":
            continue
        loops = [n for n in scope_walk(fi.node) if isinstance(n, (ast.For, ast.AsyncFor, ast.While))]
        outer = [n for n in loops if not any(o is not n and o.lineno <= n.lineno and n.end_lineno <= o.end_lineno
                                             for o in loops)]
        out[fi.qualname] = {"sites": sorted(n.lineno for n, _ in rules_mod.loop_sync_sites(idx, fi)),
                            "loops": sorted((n.lineno, n.end_lineno) for n in outer)}
    return out
