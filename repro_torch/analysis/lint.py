"""Policy linter — the port's written rules as an AST pass (``GUST-Lxx``).

Counterpart of ``repro.analysis.lint``.  Each rule encodes a policy of
the port (ROADMAP.md's ground rules and the reference contracts it
inherits); ``python -m repro_torch.analysis lint`` exits nonzero on any
finding.  It reads only the ``repro_torch/`` directory of the repository
it is given, and reports paths relative to that repository's root
(``repro_torch/serving/serve_loop.py``):

* **GUST-L01** (import policy): no module of the port imports ``jax``
  or ``repro`` at any scope (the static twin of
  ``tests/test_torch_plan.py::test_import_loads_neither_jax_nor_repro``);
  and the lazy packages (``repro_torch/__init__.py``,
  ``repro_torch/analysis/__init__.py``, ``repro_torch/core/__init__.py``)
  import nothing heavy at module scope (no ``torch``, no ``repro_torch``
  submodule, no relative import) outside ``if TYPE_CHECKING:``, so that
  importing them, or a torch-free host module under them, loads no
  torch.
* **GUST-L03** (single decision points): ``resolve_layout`` /
  ``resolve_gather`` / ``resolve_tuning`` / ``resolve_fallback`` are
  *called* only from their sanctioned sites (the allowlist).
* **GUST-L04** (deprecation policy): no in-package call site of the
  deprecated spellings ``spmv`` / ``gust_spmm_auto`` / ``SparsityConfig``.
* **GUST-L05** (store format rule): no ``np.savez`` /
  ``np.savez_compressed`` — numpy's container cannot round-trip bfloat16.
* **GUST-L06** (store/cache key rule): the execution knobs ``workers``,
  ``backend``, ``pipeline`` never appear in a ``.get`` / ``.setdefault``
  / ``.memo`` key or a subscript — one artifact serves every execution
  configuration.
* **GUST-L07** (containment rule): on the serving path (``serving/``,
  ``launch/serve.py``, ``core/plan.py``, ``core/plan_store.py``,
  ``kernels/ops.py``, ``resilience/``) a broad ``except`` whose body only
  swallows (``pass`` / ``...``) is banned outside the allowlisted
  containment sites.

The reference's GUST-L02 (no new public free function) is not adopted:
the port mirrors the reference's public free functions by design.

Allowlist format (``lint_allowlist.txt``, beside this file)::

    # comment lines and blanks are ignored
    GUST-L03  repro_torch/core/plan.py::GustPlan.layout   # why

i.e. ``<rule-id>  <path-relative-to-the-repository>::<qualified name>``
with ``<module>`` as the qualname of module-level statements.  An entry
silences exactly that rule at exactly that site.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["LintFinding", "lint_sources", "load_allowlist", "LINT_RULES"]

LINT_RULES: Dict[str, str] = {
    "GUST-L01": "jax/repro imported by the port, or an eager import in a lazy package",
    "GUST-L03": "resolve_* called outside its sanctioned decision point",
    "GUST-L04": "call site of a deprecated shim spelling",
    "GUST-L05": "np.savez on artifact paths (bfloat16 cannot round-trip)",
    "GUST-L06": "execution knob (workers/backend/pipeline) in a cache key",
    "GUST-L07": "bare except-pass on the serving path (unsanctioned swallow)",
}

#: The directory, under the repository's root, that the linter reads.
PACKAGE = "repro_torch"

#: Packages whose module scope imports nothing heavy (GUST-L01).
_LAZY_PACKAGES = (
    "repro_torch/__init__.py",
    "repro_torch/analysis/__init__.py",
    "repro_torch/core/__init__.py",
)

#: Never imported by the port, at any scope (GUST-L01).
_FOREIGN = ("jax", "jaxlib", "repro")

#: Not imported at a lazy package's module scope (GUST-L01).
_HEAVY = _FOREIGN + ("torch", PACKAGE)

#: The single-decision-point functions (GUST-L03).
_DECISION_POINTS = (
    "resolve_layout", "resolve_gather", "resolve_tuning", "resolve_fallback",
)

#: Deprecated spellings whose call sites are banned in the package (GUST-L04).
_DEPRECATED = ("spmv", "gust_spmm_auto", "SparsityConfig")

#: Execution knobs that must never reach a cache/store key (GUST-L06).
_EXEC_KNOBS = ("workers", "backend", "pipeline")

#: Serving-path prefixes where silent exception swallowing is banned
#: (GUST-L07): every file a request's tokens flow through.
_SERVING_PATHS = (
    "repro_torch/serving/",
    "repro_torch/launch/serve.py",
    "repro_torch/core/plan.py",
    "repro_torch/core/plan_store.py",
    "repro_torch/kernels/ops.py",
    "repro_torch/resilience/",
)


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str       # relative to the repository's root
    line: int
    qualname: str
    message: str

    @property
    def site(self) -> str:
        return f"{self.path}::{self.qualname}"

    def __str__(self) -> str:
        return f"[{self.rule}] {self.path}:{self.line} ({self.qualname}): " \
               f"{self.message}"


def _default_allowlist() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_allowlist.txt")


def load_allowlist(path: Optional[str] = None) -> Set[Tuple[str, str]]:
    """Parse the allowlist into ``{(rule, site)}`` pairs."""
    path = path or _default_allowlist()
    entries: Set[Tuple[str, str]] = set()
    if not os.path.exists(path):
        return entries
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"bad allowlist line: {raw.rstrip()!r}")
            entries.add((parts[0], parts[1].strip()))
    return entries


class _Visitor(ast.NodeVisitor):
    """One file's pass: tracks the qualname scope stack and whether the
    current statement sits under ``if TYPE_CHECKING:``."""

    def __init__(self, relpath: str):
        self.relpath = relpath
        self.scope: List[str] = []
        self.type_checking = 0
        self.findings: List[LintFinding] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(LintFinding(
            rule=rule, path=self.relpath,
            line=getattr(node, "lineno", 0),
            qualname=self.qualname, message=message,
        ))

    # -- scopes -------------------------------------------------------------

    def _visit_scoped(self, node, name: str) -> None:
        self.scope.append(name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._visit_scoped(node, node.name)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_scoped(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_If(self, node: ast.If) -> None:
        test = node.test
        is_tc = (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") \
            or (isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING")
        if is_tc:
            self.type_checking += 1
            for child in node.body:
                self.visit(child)
            self.type_checking -= 1
            for child in node.orelse:
                self.visit(child)
        else:
            self.generic_visit(node)

    # -- GUST-L01 -----------------------------------------------------------

    def _eager_in_lazy_package(self) -> bool:
        return (self.relpath in _LAZY_PACKAGES and not self.scope
                and not self.type_checking)

    def _check_import(self, node, module: str) -> None:
        root = module.split(".", 1)[0]
        if root in _FOREIGN:
            self._emit("GUST-L01", node,
                       f"import of {module!r}: the port imports neither jax nor repro")
        elif root in _HEAVY and self._eager_in_lazy_package():
            self._emit("GUST-L01", node,
                       f"module-scope import of {module!r} in a lazy package")

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            self._check_import(node, node.module)
        elif node.level and self._eager_in_lazy_package():
            self._emit("GUST-L01", node,
                       "module-scope relative import in a lazy package")
        self.generic_visit(node)

    # -- calls: GUST-L03 / L04 / L05 / L06 ----------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        name = None
        if isinstance(fn, ast.Name):
            name = fn.id
        elif isinstance(fn, ast.Attribute):
            name = fn.attr
        if name in _DECISION_POINTS:
            self._emit("GUST-L03", node,
                       f"{name}() called here — decision points have "
                       "sanctioned callers only")
        if isinstance(fn, ast.Name) and fn.id in _DEPRECATED:
            self._emit("GUST-L04", node, f"call to deprecated {fn.id!r}")
        elif (isinstance(fn, ast.Attribute) and fn.attr in _DEPRECATED
              and isinstance(fn.value, ast.Name) and fn.value.id == PACKAGE):
            self._emit("GUST-L04", node, f"call to deprecated {PACKAGE}.{fn.attr}")
        if isinstance(fn, ast.Attribute) \
                and fn.attr in ("savez", "savez_compressed") \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id in ("np", "numpy"):
            self._emit("GUST-L05", node,
                       f"np.{fn.attr} cannot round-trip bfloat16 leaves; "
                       "use the PlanStore container")
        if isinstance(fn, ast.Attribute) \
                and fn.attr in ("get", "setdefault", "memo") and node.args:
            self._check_key_expr(node.args[0])
        self.generic_visit(node)

    def _check_key_expr(self, expr: ast.AST) -> None:
        for sub in ast.walk(expr):
            knob = None
            if isinstance(sub, ast.Name) and sub.id in _EXEC_KNOBS:
                knob = sub.id
            elif isinstance(sub, ast.Attribute) and sub.attr in _EXEC_KNOBS:
                knob = sub.attr
            if knob:
                self._emit("GUST-L06", sub,
                           f"execution knob {knob!r} inside a cache-key "
                           "expression (one artifact serves all execution "
                           "configs)")

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, (ast.Store, ast.Load)):
            self._check_key_expr(node.slice)
        self.generic_visit(node)

    # -- GUST-L07 -----------------------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        on_serving_path = any(
            self.relpath.startswith(p) if p.endswith("/") else self.relpath == p
            for p in _SERVING_PATHS
        )
        if on_serving_path:
            broad = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException")
            )
            swallows = all(
                isinstance(st, ast.Pass)
                or (isinstance(st, ast.Expr)
                    and isinstance(st.value, ast.Constant)
                    and st.value.value is Ellipsis)
                for st in node.body
            )
            if broad and swallows:
                self._emit(
                    "GUST-L07", node,
                    "broad except that only swallows on the serving path — "
                    "retire/count/degrade/re-raise, or allowlist the "
                    "sanctioned containment site",
                )
        self.generic_visit(node)


def _repository_root() -> str:
    # .../<root>/repro_torch/analysis/lint.py -> .../<root>
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def lint_sources(
    root: Optional[str] = None,
    allowlist: Optional[str] = None,
) -> List[LintFinding]:
    """Lint every ``.py`` under ``<root>/repro_torch`` (``root`` defaults to
    the repository this package lives in) and return the findings the
    allowlist does not silence.  Nothing outside that directory is read."""
    root = _repository_root() if root is None else root
    allowed = load_allowlist(allowlist)
    findings: List[LintFinding] = []
    for dirpath, dirnames, files in os.walk(os.path.join(root, PACKAGE)):
        dirnames.sort()
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError as e:
                    findings.append(LintFinding(
                        rule="GUST-L00", path=rel, line=e.lineno or 0,
                        qualname="<module>", message=f"syntax error: {e}"))
                    continue
            v = _Visitor(rel)
            v.visit(tree)
            findings.extend(v.findings)
    return [f for f in findings if (f.rule, f.site) not in allowed]
