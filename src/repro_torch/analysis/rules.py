"""The port's lint rules — ``repro.analysis.rules`` retargeted to the risks
of eager PyTorch on a card, and scoped to ``repro_torch/...`` paths.

* **SYN001** — host syncs (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, and ``int()``/``float()``/``bool()`` of a value that may be
  a tensor) inside serving callables: ``ServePlan.diag``/``routed_diag``/
  ``full``, ``decode_step``, and the prediction functions a module
  registers as a ``GPMethod``'s ``predict_*_fn`` (the callables ``api``'s
  plans build over them). Each one stalls the host until the card drains,
  on every request.
* **DTY001** — float64 forced into the f32 serving path (``.double()``, or
  ``torch.float64`` passed as a dtype: ``.to(torch.float64)``,
  ``dtype=torch.float64``, ``promote_types(x, torch.float64)``).
  Dtype-conditional ternaries that inspect an input's ``.dtype`` mirror the
  caller's dtype and are exempt; the port's deliberate float64 places carry
  a scoped suppression with the reason on the line above.
* **DET001** — unseeded RNG or wall-clock calls in the deterministic-replay
  modules (chaos, health, stats, scheduler), and a ``torch`` sampler
  (``torch.rand*``, ``randn``, ``randint``, ``randperm``, ``normal``)
  called without ``generator=`` there.
* **FRZ001** — mutation of frozen plan/spec dataclasses (use
  ``dataclasses.replace`` instead), as the reference's.

The reference's ``JIT001``-``JIT003`` guard ``jax.jit`` tracing: truthiness
of a traced value, host syncs inside a jitted function, Python scalars
that re-specialize an executable. Eager PyTorch has no tracer, so the first
and third have no counterpart; ``SYN001`` takes over the purpose of
``JIT001``/``JIT002``: the host reads that now stall a serving call.

Rules are path-scoped with substring prefixes so test fixtures can opt in
by using a matching fake path.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator

from repro_torch.analysis.engine import Finding, ModuleInfo, Rule

__all__ = ["ALL_RULES", "default_rules", "SYN001", "DTY001", "DET001",
           "FRZ001"]


# -- shared AST helpers -----------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for Attribute/Name chains, '' for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _in_scope(path: str, prefixes: tuple[str, ...]) -> bool:
    return any(p in path for p in prefixes)


# -- SYN001 -----------------------------------------------------------------

class SYN001(Rule):
    """A host sync inside a serving callable: ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, or ``int()``/``float()``/``bool()`` of
    anything but a literal, ``len()``, or a shape (``.shape``, ``.ndim``,
    ``.size()``, ``.numel()``, ``.dim()``). The serving callables are the
    defs named in ``CALLABLES`` and, in a module that registers a
    ``GPMethod``, the functions it passes as ``predict_*_fn``."""
    name = "SYN001"
    SCOPE = ("repro_torch/",)
    CALLABLES = frozenset({"diag", "routed_diag", "full", "decode_step"})
    IMPL_KWARGS = frozenset({"predict_fn", "predict_diag_fn",
                             "predict_routed_diag_fn"})
    SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})
    SHAPE_ATTRS = frozenset({"shape", "ndim"})
    SHAPE_CALLS = frozenset({"size", "numel", "dim", "len"})

    def _serving_names(self, tree: ast.Module) -> set[str]:
        names = set(self.CALLABLES)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in self.IMPL_KWARGS and \
                            isinstance(kw.value, ast.Name):
                        names.add(kw.value.id)
        return names

    def _shape_like(self, arg: ast.AST) -> bool:
        if isinstance(arg, ast.Constant):
            return True
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Attribute) and sub.attr in self.SHAPE_ATTRS:
                return True
            if isinstance(sub, ast.Call) and \
                    _dotted(sub.func).split(".")[-1] in self.SHAPE_CALLS:
                return True
        return False

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        if not _in_scope(module.path, self.SCOPE):
            return
        names = self._serving_names(module.tree)
        for fn in _functions(module.tree):
            if fn.name not in names:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in self.SYNC_METHODS:
                    yield module.finding(
                        self.name, node,
                        f".{f.attr}() in serving callable '{fn.name}' "
                        "synchronizes the host with the card on every "
                        "call")
                elif (isinstance(f, ast.Name)
                      and f.id in ("int", "float", "bool") and node.args
                      and not self._shape_like(node.args[0])):
                    yield module.finding(
                        self.name, node,
                        f"{f.id}() of a possible tensor in serving callable "
                        f"'{fn.name}' synchronizes the host with the card")


# -- DTY001 -----------------------------------------------------------------

class DTY001(Rule):
    """float64 forced into a serving-path module, against the ServeSpec
    dtype policy (serving is f32 end to end; f64 is the offline reference
    dtype): ``.double()``, or float64 passed as a call's dtype argument
    (positional or ``dtype=``). Dtype-conditional ternaries that inspect an
    input's ``.dtype`` are exempt: mirroring the caller's dtype is the
    policy."""
    name = "DTY001"
    SCOPE = ("repro_torch/serving/", "repro_torch/launch/gp_serve.py",
             "repro_torch/launch/serve.py", "repro_torch/launch/scheduler.py",
             "repro_torch/kernels/", "repro_torch/core/",
             "repro_torch/models/")

    @staticmethod
    def _is_f64(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return node.value == "float64"
        return isinstance(node, (ast.Attribute, ast.Name)) and \
            _dotted(node).split(".")[-1] == "float64"

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        if not _in_scope(module.path, self.SCOPE):
            return
        # anything under a dtype-conditional ternary is policy-compliant
        exempt: set[int] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.IfExp) and any(
                    isinstance(s, ast.Attribute) and s.attr == "dtype"
                    for s in ast.walk(node.test)):
                for sub in ast.walk(node):
                    exempt.add(id(sub))
        for node in ast.walk(module.tree):
            if id(node) in exempt or not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "double" and not node.args:
                yield module.finding(
                    self.name, node,
                    ".double() in a serving-path module violates the "
                    "ServeSpec f32 dtype policy")
                continue
            if any(self._is_f64(a) for a in node.args):
                yield module.finding(
                    self.name, node,
                    "float64 passed as a dtype in a serving-path module "
                    "violates the ServeSpec f32 dtype policy")
                continue
            for kw in node.keywords:
                if kw.arg == "dtype" and id(kw.value) not in exempt and \
                        self._is_f64(kw.value):
                    yield module.finding(
                        self.name, node,
                        "dtype=float64 in a serving-path module violates "
                        "the ServeSpec f32 dtype policy")


# -- DET001 -----------------------------------------------------------------

class DET001(Rule):
    """Unseeded RNG or wall-clock *calls* in deterministic-replay modules.
    References (e.g. ``sleep=time.sleep`` as an injectable default) are
    fine; calling the global clock or an unseeded sampler inside replay
    logic is not. A ``torch`` sampler draws from the process's global
    generator unless it is given ``generator=``."""
    name = "DET001"
    SCOPE = ("repro_torch/serving/chaos.py", "repro_torch/serving/health.py",
             "repro_torch/serving/stats.py",
             "repro_torch/serving/scheduler.py")
    GLOBAL_SAMPLERS = frozenset({
        "rand", "randn", "randint", "random", "random_sample", "choice",
        "shuffle", "permutation", "normal", "uniform", "standard_normal"})
    TORCH_SAMPLERS = frozenset({
        "rand", "rand_like", "randn", "randn_like", "randint",
        "randint_like", "randperm", "normal", "bernoulli", "multinomial"})
    CLOCKS = frozenset({"time.time", "time.monotonic", "time.perf_counter",
                        "time.time_ns", "time.monotonic_ns"})

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        if not _in_scope(module.path, self.SCOPE):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name in self.CLOCKS:
                yield module.finding(
                    self.name, node,
                    f"{name}() call in a deterministic-replay module; "
                    "thread an injectable clock instead")
            elif name.startswith("random."):
                yield module.finding(
                    self.name, node,
                    f"stdlib global-RNG call {name}() breaks seeded "
                    "replay; use np.random.RandomState(seed)")
            elif name in ("np.random.RandomState", "numpy.random.RandomState",
                          "np.random.default_rng", "numpy.random.default_rng"):
                if not node.args and not node.keywords:
                    yield module.finding(
                        self.name, node,
                        f"{name}() without a seed breaks deterministic "
                        "replay")
            elif (name.startswith(("np.random.", "numpy.random."))
                  and name.split(".")[-1] in self.GLOBAL_SAMPLERS):
                yield module.finding(
                    self.name, node,
                    f"{name}() samples numpy's process-global RNG; use a "
                    "seeded RandomState")
            elif (name.startswith("torch.")
                  and name.split(".")[-1] in self.TORCH_SAMPLERS
                  and not any(kw.arg == "generator" for kw in node.keywords)):
                yield module.finding(
                    self.name, node,
                    f"{name}() without generator= samples torch's "
                    "process-global RNG; pass a seeded torch.Generator")


# -- FRZ001 -----------------------------------------------------------------

class FRZ001(Rule):
    """Attribute assignment on a frozen plan/spec dataclass.  Frozen
    classes are collected from the module itself plus the repo's known
    frozen API types, so cross-module mutation of a ``spec``/``plan``
    parameter is caught too.  ``object.__setattr__`` is only legitimate
    inside ``__post_init__``."""
    name = "FRZ001"
    KNOWN_FROZEN = frozenset({
        "ServeSpec", "ServePlan", "PICServePlan", "GPMethod", "FittedGP",
        "HealthPolicy", "FaultPlan", "KernelSpec"})

    @staticmethod
    def _frozen_classes(tree: ast.Module) -> set[str]:
        out = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and \
                        _dotted(dec.func) in ("dataclass", "dataclasses.dataclass"):
                    for kw in dec.keywords:
                        if kw.arg == "frozen" and \
                                isinstance(kw.value, ast.Constant) and \
                                kw.value.value is True:
                            out.add(node.name)
        return out

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        local_frozen = self._frozen_classes(module.tree)
        frozen = local_frozen | self.KNOWN_FROZEN

        # 1. methods of locally-defined frozen classes
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.ClassDef) and node.name in local_frozen):
                continue
            for meth in node.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                in_post_init = meth.name == "__post_init__"
                for sub in ast.walk(meth):
                    if isinstance(sub, (ast.Assign, ast.AugAssign)):
                        tgts = sub.targets if isinstance(sub, ast.Assign) \
                            else [sub.target]
                        for t in tgts:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                yield module.finding(
                                    self.name, sub,
                                    f"direct field assignment in frozen "
                                    f"dataclass {node.name} raises "
                                    "FrozenInstanceError; use "
                                    "dataclasses.replace")
                    if (not in_post_init and isinstance(sub, ast.Call)
                            and _dotted(sub.func) == "object.__setattr__"):
                        yield module.finding(
                            self.name, sub,
                            f"object.__setattr__ outside __post_init__ "
                            f"mutates frozen dataclass {node.name}")

        # 2. mutation through a variable known to hold a frozen instance
        for fn in _functions(module.tree):
            frozen_vars: set[str] = set()
            args = fn.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.annotation is not None and \
                        _dotted(a.annotation).split(".")[-1] in frozen:
                    frozen_vars.add(a.arg)
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Call) and \
                        _dotted(sub.value.func).split(".")[-1] in frozen:
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            frozen_vars.add(t.id)
            if not frozen_vars:
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    tgts = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in tgts:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id in frozen_vars):
                            yield module.finding(
                                self.name, sub,
                                f"assignment to field of frozen instance "
                                f"'{t.value.id}' raises "
                                "FrozenInstanceError; use "
                                "dataclasses.replace")


ALL_RULES = (SYN001, DTY001, DET001, FRZ001)


def default_rules() -> list[Rule]:
    return [cls() for cls in ALL_RULES]
