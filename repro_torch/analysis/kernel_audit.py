"""Hopper resource audit — static ``GUST-Hxx`` checks of the port's CUDA
kernels against the card's budgets.

Counterpart of ``repro.analysis.kernel_audit``, which checks the Pallas
builders against the TPU core's VMEM (K01), their double-buffer
start/wait pairing (K02) and their steering tables' bounds (K03).  Here
the budgets are the H100's (``sm_90a``), read from two sources:

* **per kernel**, ``ptxas``' report of each library's build
  (``-Xptxas=-v``, kept beside the library by ``kernels._build``, so a
  cached build is audited too):

  * ``GUST-H01`` — registers a thread: at most 255;
  * ``GUST-H02`` — no spill stores or loads, in any function;
  * ``GUST-H03`` — static shared memory a CTA: at most 48 KiB (the
    static allocation limit; more must be dynamic);

* **per launch plan** — the launch a kernel makes on the card for one
  stream, as ``gust_spmv.spread_launch_plan`` (kernels 1-8) and
  ``gust_spgemm.spgemm_launch_plan`` (kernel 9) report it from the
  occupancy calculator, each with its ``launch`` context:

  * ``GUST-H04`` — static plus dynamic shared memory a CTA at most
    232,448 bytes (227 KiB), and the CTAs an SM holds at once with 1 KiB
    reserved each within its 233,472 (228 KiB);
  * ``GUST-H05`` — registers: the instance's registers a thread, in the
    warp's allocation unit of 256 registers, times its warps, times the
    CTAs per SM the plan assumes, at most 65,536 an SM;
  * ``GUST-H06`` — the grid stays within the stream (K03's counterpart,
    from the plan's own numbers): the spread kernels' persistent grid
    runs ``1 <= grid_x <= T_blk`` CTAs, each a non-empty run of blocks,
    no more than the SMs hold at once, and ``grid_y`` column tiles cover
    the ``B`` vector columns exactly; the SpGEMM row-tile kernel's grid is
    its CTAs per SM times the SMs.

The register and shared-memory numbers of a launch are those of the very
template instance it runs (value and index type, column tile, gather,
x-tile stages, stream stages), found by its mangled name in the report.

* **per source**, from the CUDA text alone (no ``nvcc``), K02's
  counterpart (the reference's Pallas start/wait pairing):

  * ``GUST-H07`` — every asynchronous copy is completed before what it
    fills is read, and none writes what is still to be read.  Each
    ``__global__`` function that issues one (through the primitives of
    ``csrc/gust_common.cuh``) is simulated once per template instance its
    ``static_assert`` admits, along its statements: a ``cp.async``
    group must be committed (``cp_async_commit``), waited on
    (``cp_async_wait<0>``) and published (``__syncthreads()``) before
    its segment-table row or x-tile stage is read; a TMA fill of a stream
    stage (``mbar_arrive_expect_tx`` expecting exactly the bytes of its
    ``bulk_copy_g2s`` copies, all on the stage's own barrier) must be
    waited on (``mbar_wait`` on that barrier at the parity of that fill)
    before the stage is read; and a copy may write a buffer only once it
    has been read and every thread is past a ``__syncthreads()`` since
    (for a bulk copy also past ``fence_proxy_async_shared()``), so a
    refill goes into the stage just read, never one still to be read.
    The simulation runs the kernel's loops four times (one chunk a block,
    so every iteration starts a block) and takes every branch that the
    template's constants do not decide (both arms, merged, where there
    is an ``else``).  :func:`audit_rings` says for each source what it
    checked, also where a source issues no asynchronous copy.

Entry points: :func:`audit_kernels` → :class:`AuditResult` (H01..H07);
``python -m repro_torch.analysis audit`` prints its report and exits
nonzero on any finding.  It builds what is not built (``nvcc``), so it
runs where the card and the toolkit are; :func:`audit_rings` (``audit
--rings``) needs neither.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import os
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "RULES",
    "AuditFinding",
    "KernelReport",
    "AuditResult",
    "parse_ptxas",
    "audit_reports",
    "audit_plan",
    "audit_kernels",
    "audit_rings",
    "RingAudit",
    "default_plans",
    "MAX_REGISTERS",
    "MAX_STATIC_SMEM",
    "MAX_SMEM_PER_CTA",
    "SMEM_PER_SM",
    "REGISTERS_PER_SM",
]

#: Registers a thread can address (sm_90).
MAX_REGISTERS = 255
#: Static shared memory a CTA may declare (larger needs dynamic memory).
MAX_STATIC_SMEM = 48 * 1024
#: Shared memory a CTA may use with the opt-in (227 KiB on sm_90).
MAX_SMEM_PER_CTA = 232_448
#: Shared memory of one SM (228 KiB), of which each resident CTA reserves 1 KiB.
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_CTA = 1024
#: The register file of one SM, and the unit a warp's registers come in.
REGISTERS_PER_SM = 65_536
REGISTER_UNIT = 256

#: rule id -> one-line contract.
RULES: Dict[str, str] = {
    "GUST-H01": f"registers a thread <= {MAX_REGISTERS}",
    "GUST-H02": "no spill stores or loads in any function",
    "GUST-H03": f"static shared memory a CTA <= {MAX_STATIC_SMEM} bytes",
    "GUST-H04": (f"static + dynamic shared memory a CTA <= {MAX_SMEM_PER_CTA} bytes, "
                 f"and CTAs per SM x (shared + {SMEM_RESERVED_PER_CTA}) <= "
                 f"{SMEM_PER_SM}"),
    "GUST-H05": (f"registers (in units of {REGISTER_UNIT} a warp) x warps x CTAs "
                 f"per SM <= {REGISTERS_PER_SM}"),
    "GUST-H06": "the launch grid stays within the stream's blocks and the card",
    "GUST-H07": ("every asynchronous copy is waited on before what it fills is read, "
                 "and writes only what has been read"),
}


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    rule: str
    where: str  # library/function, or the plan's tag
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}:error] {self.where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class KernelReport:
    """One entry function of a library, from ``ptxas -v``."""

    library: str
    mangled: str
    name: str  # the function's own name, e.g. ``spread_partials``
    template: str  # its mangled template arguments ("" if none)
    registers: int
    static_smem: int
    spill_stores: int
    spill_loads: int

    def __str__(self) -> str:
        args = f"<{self.template}>" if self.template else ""
        return (f"{self.library}/{self.name}{args}: {self.registers} registers, "
                f"{self.static_smem} bytes static smem, {self.spill_stores}/"
                f"{self.spill_loads} bytes spill stores/loads")


def _demangle_name(mangled: str) -> Tuple[str, str]:
    """(function name, mangled template arguments) of a mangled kernel:
    the last length-prefixed component of ``_ZN<n>ns<n>name[I...]E...``
    (or ``_Z<n>name...``).  A kernel returns void, so its template
    argument list ends where ``E`` (closing it), ``E`` (closing the nested
    name) and ``v`` (the return type) meet."""
    nested = mangled.startswith("_ZN")
    i = 3 if nested else 2
    name = ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if i >= len(mangled) or mangled[i] != "I":
        return name, ""
    end = mangled.find("EEv" if nested else "Ev", i)
    return name, mangled[i + 1:end] if end > i else mangled[i + 1:]


def parse_ptxas(library: str, text: str) -> List[KernelReport]:
    """The entry functions of one library's ``ptxas -v`` report: ptxas
    names each ("Compiling entry function 'NAME'"), then its stack and
    spills ("Function properties for NAME" and the line after), then its
    registers and static shared memory ("Used N registers, ...")."""
    out: List[KernelReport] = []
    entry: Optional[str] = None
    props: Dict[str, Tuple[int, int]] = {}
    current: Optional[str] = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            props[current] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            stores, loads = props.get(entry, (0, 0))
            name, template = _demangle_name(entry)
            out.append(KernelReport(
                library=library, mangled=entry, name=name, template=template,
                registers=int(m.group(1)), static_smem=int(smem.group(1)) if smem else 0,
                spill_stores=stores, spill_loads=loads))
            entry = None
    # spills of non-entry (device) functions count too
    for fn, (stores, loads) in props.items():
        if (stores or loads) and not any(r.mangled == fn for r in out):
            name, template = _demangle_name(fn)
            out.append(KernelReport(library, fn, name, template, 0, 0, stores, loads))
    return out


def audit_reports(reports: Iterable[KernelReport]) -> List[AuditFinding]:
    """GUST-H01..H03 over every reported function."""
    out: List[AuditFinding] = []
    for r in reports:
        where = f"{r.library}/{r.name}" + (f"<{r.template}>" if r.template else "")
        if r.registers > MAX_REGISTERS:
            out.append(AuditFinding("GUST-H01", where,
                                    f"{r.registers} registers a thread > {MAX_REGISTERS}"))
        if r.spill_stores or r.spill_loads:
            out.append(AuditFinding(
                "GUST-H02", where,
                f"{r.spill_stores} bytes spill stores, {r.spill_loads} bytes spill loads"))
        if r.static_smem > MAX_STATIC_SMEM:
            out.append(AuditFinding(
                "GUST-H03", where,
                f"{r.static_smem} bytes of static shared memory > {MAX_STATIC_SMEM}"))
    return out


#: Mangled spellings of the spread template's value and index types.
_MANGLED_TYPES = {"float32": "f", "bfloat16": "13__nv_bfloat16", "int8": "a",
                  "int32": "i", "int16": "s"}


def spread_instance(launch: Dict, stream_stages: int) -> str:
    """The mangled template arguments of the ``spread_partials`` instance
    a spread launch runs (``csrc/gust_spread.cuh``: value and index type,
    QUANT, the column tile BT, the gather, the x-tile stages and the
    stream stages)."""
    local = launch["gather"] == "local"
    stages = 0 if not local else (2 if launch["pipeline"] == "double" else 1)
    bt = 1 if launch["b"] == 1 else 8
    return (f"{_MANGLED_TYPES[launch['value_dtype']]}"
            f"{_MANGLED_TYPES[launch['index_dtype']]}"
            f"Lb{int(launch['value_dtype'] == 'int8')}ELi{bt}E"
            f"LNS_6GatherE{int(local)}ELi{stages}ELi{stream_stages}E")


def _instance(plan: Dict, reports: Sequence[KernelReport]) -> Optional[KernelReport]:
    launch = plan["launch"]
    if launch["kernel"] == "spread_partials":
        want = spread_instance(launch, plan["stream_stages"])
    else:
        want = None
    for r in reports:
        if r.library == launch["library"] and r.name == launch["kernel"] and (
                want is None or r.template == want):
            return r
    return None


def plan_tag(plan: Dict) -> str:
    launch = plan["launch"]
    if launch["kernel"] == "spread_partials":
        return (f"{launch['library']}/spread_partials {launch['value_dtype']}/"
                f"{launch['index_dtype']} {launch['gather']}/{launch['pipeline']} "
                f"B={launch['b']} T_blk={launch['t_blk']} l={launch['l']}")
    return f"{launch['library']}/{launch['kernel']}"


def audit_plan(plan: Dict, reports: Sequence[KernelReport]) -> List[AuditFinding]:
    """GUST-H04..H06 for one launch plan, against the report of the
    kernel instance it launches."""
    launch, tag = plan["launch"], plan_tag(plan)
    inst = _instance(plan, reports)
    if inst is None:
        return [AuditFinding("GUST-H05", tag, "no ptxas report of the instance this "
                                              "plan launches")]
    out: List[AuditFinding] = []
    ctas = plan["ctas_per_sm"]
    smem = inst.static_smem + plan["smem_bytes"]
    if smem > MAX_SMEM_PER_CTA:
        out.append(AuditFinding("GUST-H04", tag, f"{inst.static_smem} static + "
                                f"{plan['smem_bytes']} dynamic = {smem} bytes a CTA > "
                                f"{MAX_SMEM_PER_CTA}"))
    elif ctas * (smem + SMEM_RESERVED_PER_CTA) > SMEM_PER_SM:
        out.append(AuditFinding("GUST-H04", tag, f"{ctas} CTAs x ({smem} + "
                                f"{SMEM_RESERVED_PER_CTA}) bytes > {SMEM_PER_SM} an SM"))
    warps = -(-launch["threads"] // 32)
    per_warp = -(-inst.registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    if per_warp * warps * ctas > REGISTERS_PER_SM:
        out.append(AuditFinding("GUST-H05", tag, f"{inst.registers} registers ({per_warp} "
                                f"a warp) x {warps} warps x {ctas} CTAs = "
                                f"{per_warp * warps * ctas} > {REGISTERS_PER_SM}"))
    sms = launch["sms"]
    if launch["kernel"] == "spread_partials":
        bt = 1 if launch["b"] == 1 else 8
        resident = -(-sms * ctas // max(plan["grid_y"], 1))
        if not 1 <= plan["grid_x"] <= min(launch["t_blk"], resident):
            out.append(AuditFinding("GUST-H06", tag, f"grid_x {plan['grid_x']} outside "
                                    f"[1, min(T_blk {launch['t_blk']}, {resident} "
                                    "resident CTAs a column tile)]"))
        if plan["grid_y"] != -(-launch["b"] // bt):
            out.append(AuditFinding("GUST-H06", tag, f"grid_y {plan['grid_y']} column "
                                    f"tiles of {bt} for B={launch['b']}"))
    elif plan["grid"] != ctas * sms or plan["grid"] < 1:
        out.append(AuditFinding("GUST-H06", tag, f"grid {plan['grid']} != {ctas} CTAs "
                                f"per SM x {sms} SMs"))
    return out


# ---------------------------------------------------------------------------
# GUST-H07: the asynchronous copies of the CUDA sources
# ---------------------------------------------------------------------------

#: The copy primitives of ``csrc/gust_common.cuh``: per-thread ``cp.async``
#: (completed by commit and wait groups) and the TMA bulk copy (completed
#: on an mbarrier).
_CP_ASYNC = ("cp_async4", "cp_async16")
_BULK = "bulk_copy_g2s"
#: Iterations the simulation gives a loop of the kernel body (its own
#: condition stops it sooner where the template's constants decide it).
_RUNS = 4
#: Runtime values the simulation pins: a CTA's run starts at block 0 and
#: every block is one chunk, so each iteration of the main loop starts a
#: block (``ci == 0``) and ends it (``last``).
_PINNED = {"ta": 0, "nchunk": 1}
#: Template constants of the spread kernels and the values they range over.
_CONSTANTS = {"LOCAL": (False, True), "STAGES": (0, 1, 2), "RING": (0, 2)}

# buffer states, worst last
_VISIBLE, _WAITED, _COMMITTED, _ISSUED, _IN_FLIGHT = range(5)
_STATE = {
    _WAITED: "waited on (cp_async_wait) but not yet published by __syncthreads()",
    _COMMITTED: "committed but not waited on (cp_async_wait)",
    _ISSUED: "issued but not committed (cp_async_commit)",
    _IN_FLIGHT: "in flight (no mbar_wait on its barrier)",
}
_NAMES = {"ring": "segment-table row", "stage_of": "x-tile stage",
          "slots_of": "stream stage"}


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _close(text: str, i: int) -> int:
    """Index of the bracket that closes the one at ``text[i]``."""
    pair = {"(": ")", "[": "]", "{": "}"}
    depth = 0
    for k in range(i, len(text)):
        if text[k] == text[i]:
            depth += 1
        elif text[k] == pair[text[i]]:
            depth -= 1
            if depth == 0:
                return k
    raise ValueError(f"unbalanced {text[i]!r} at {i}")


def _split_top(text: str, sep: str = ",") -> List[str]:
    """``text`` split at the ``sep`` characters outside brackets."""
    out, depth, start = [], 0, 0
    for k, c in enumerate(text):
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif c == sep and depth == 0:
            out.append(text[start:k])
            start = k + 1
    out.append(text[start:])
    return [p.strip() for p in out]


def _unparen(e: str) -> str:
    e = e.strip()
    while e.startswith("(") and _close(e, 0) == len(e) - 1:
        e = e[1:-1].strip()
    return e


def _py(expr: str) -> str:
    """A C expression of the kernels as Python (casts dropped, integer
    division, one conditional operator)."""
    e = _unparen(expr)
    e = re.sub(r"\(\s*(?:size_t|int|unsigned|long long|float)\s*\)", "", e)
    e = re.sub(r"static_cast<[^<>]*>", "", e)
    if "?" in e:
        cond, rest = e.split("?", 1)
        then, other = rest.split(":", 1)
        return f"(({_py(then)}) if ({_py(cond)}) else ({_py(other)}))"
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"!(?!=)", " not ", e)
    e = re.sub(r"(?<!/)/(?!/)", "//", e)
    return re.sub(r"\btrue\b", "True", re.sub(r"\bfalse\b", "False", e))


def _eval(expr: str, env: Dict):
    """The value of ``expr`` under ``env``, or None where it depends on
    something else (a runtime value)."""
    try:
        return eval(_py(expr), {"__builtins__": {}}, dict(env))  # noqa: S307
    except (NameError, TypeError, SyntaxError, ValueError, ZeroDivisionError,
            AttributeError):  # undecided: a name the template's constants do not give
        return None


def _calls(text: str):
    """``(name, template args, args, start)`` of every call in ``text``,
    innermost first within each call's arguments, in textual order."""
    out = []
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*(<[^<>()]*>)?\s*\(", text):
        if m.group(1) in ("if", "for", "while", "return", "sizeof"):
            continue
        lo = m.end() - 1
        hi = _close(text, lo)
        out.append((m.group(1), m.group(2) or "", _split_top(text[lo + 1:hi]), m.start()))
    return out


def _parse(text: str) -> List[Tuple]:
    """The statements of a C++ body: ``("simple", text)``, ``("block",
    stmts)``, ``("if", cond, stmts, else_stmts | None)``, ``("for",
    init, cond, step, stmts)``."""
    out, i = [], 0
    while True:
        stmt, i = _statement(text, i)
        if stmt is None:
            return out
        out.append(stmt)


def _statement(text: str, i: int):
    n = len(text)
    while i < n and (text[i].isspace() or text[i] == ";"):
        i += 1
    if i >= n:
        return None, n
    if text[i] == "#":  # a pragma: to the end of its line
        j = text.find("\n", i)
        return ("simple", ""), n if j < 0 else j
    if text[i] == "{":
        j = _close(text, i)
        return ("block", _parse(text[i + 1:j])), j + 1
    m = re.match(r"(if|for|while)\b\s*(?:constexpr\s*)?\(", text[i:])
    if m:
        lo = i + m.end() - 1
        hi = _close(text, lo)
        head = text[lo + 1:hi]
        body, j = _statement(text, hi + 1)
        body = [body] if body else []
        if m.group(1) == "if":
            orelse = None
            e = re.match(r"\s*else\b", text[j:])
            if e:
                other, j = _statement(text, j + e.end())
                orelse = [other] if other else []
            return ("if", head, body, orelse), j
        if m.group(1) == "while":
            return ("for", "", head, "", body), j
        init, cond, step = (_split_top(head, ";") + ["", ""])[:3]
        return ("for", init, cond, step, body), j
    j, depth = i, 0
    while j < n and not (text[j] == ";" and depth == 0):
        if text[j] in "([{":
            depth += 1
        elif text[j] in ")]}":
            depth -= 1
        j += 1
    return ("simple", text[i:j].strip()), j + 1


def _terms(expr: str) -> Counter:
    """``a + 2 * b`` as {a: 1, b: 2}; a term with another operator counts
    as its own text."""
    out: Counter = Counter()
    for term in _split_top(_unparen(expr), "+"):
        coef, names = 1, []
        for f in _split_top(term, "*"):
            f = _unparen(f)
            if f.isdigit():
                coef *= int(f)
            else:
                names.append(f)
        out[" * ".join(sorted(names)) or "1"] += coef
    return out


@dataclasses.dataclass
class _Lambda:
    params: List[str]
    body: List[Tuple]
    text: str


class _Sim:
    """One instance of one kernel, run along its statements."""

    _DECL = re.compile(r"^(?:const\s+)?(?:(?:unsigned|int|bool|size_t|long long|float)\s+)"
                       r"(?!\*)(.*)$")
    _PTR = re.compile(r"^(?:const\s+)?(?:[\w:<>]+\s+)*[\w:<>]+\s*\*\s*(\w+)\s*=\s*(.+)$",
                      re.S)
    _ASSIGN = re.compile(r"^(\w+)\s*=\s*(?!=)(.+)$", re.S)

    def __init__(self, where: str, env: Dict, findings: List[AuditFinding]):
        self.where, self.env, self.findings = where, dict(env), findings
        self.lambdas: Dict[str, _Lambda] = {}
        self.scopes: List[Dict[str, Tuple]] = [{}]
        self.status: Dict[Tuple, int] = {}
        self.in_use, self.needs_fence, self.unread = set(), set(), set()
        self.fills: Dict[int, int] = {}
        self.barriers = "none"  # -> "init" -> "fenced" -> "ready"
        self.writing: set = set()
        self.depth = 0  # lambda calls deep

    # -- state ----------------------------------------------------------------

    def fork(self) -> "_Sim":
        other = copy.copy(self)
        for name in ("env", "status", "fills"):
            setattr(other, name, dict(getattr(self, name)))
        for name in ("in_use", "needs_fence", "unread", "writing"):
            setattr(other, name, set(getattr(self, name)))
        other.scopes = [dict(s) for s in self.scopes]
        return other

    def merge(self, a: "_Sim", b: "_Sim") -> None:
        self.env = {k: v for k, v in a.env.items() if b.env.get(k, object()) == v}
        self.status = {k: max(a.status.get(k, 0), b.status.get(k, 0))
                       for k in set(a.status) | set(b.status)}
        self.fills = {k: max(a.fills.get(k, 0), b.fills.get(k, 0))
                      for k in set(a.fills) | set(b.fills)}
        self.in_use = a.in_use | b.in_use
        self.needs_fence = a.needs_fence | b.needs_fence
        self.unread = a.unread & b.unread  # a fill some path skips is not owed a read
        order = ["none", "init", "fenced", "ready"]
        self.barriers = min(a.barriers, b.barriers, key=order.index)
        self.scopes = [{**x, **y} for x, y in zip(a.scopes, b.scopes)]

    def find(self, message: str) -> None:
        f = AuditFinding("GUST-H07", self.where, message)
        if f not in self.findings:
            self.findings.append(f)

    @staticmethod
    def name(buf: Tuple) -> str:
        return f"{_NAMES.get(buf[0], buf[0])} {buf[1]}"

    # -- buffers --------------------------------------------------------------

    def alias(self, name: str):
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return None

    def buffer(self, expr: str):
        """The buffer (or barrier) an address expression points into."""
        m = re.search(r"\bring\s*\+\s*(.+?)\s*\*\s*cap\b", expr)
        if m:
            return ("ring", _eval(m.group(1), self.env))
        m = re.search(r"\bbars\s*\+\s*(.+)$", expr)
        if m:
            return ("bar", _eval(m.group(1), self.env))
        for name, tmpl, args, _ in _calls(expr):
            lam = self.lambdas.get(name)
            if lam is not None and re.search(r"\bsmem\b", lam.text):
                return (name, self.accessor_index(lam, args))
        for ident in re.findall(r"\b[A-Za-z_]\w*\b", expr):
            buf = self.alias(ident)
            if buf is not None:
                return buf
        return None

    def accessor_index(self, lam: _Lambda, args: List[str]):
        """An accessor's buffer index: the factor of its ``lay.<field>``."""
        env = dict(self.env)
        for p, a in zip(lam.params, args):
            env[p] = _eval(a, self.env)
        m = re.search(r"\(([^()]*(?:\([^()]*\)[^()]*)*)\)\s*\*\s*lay\.\w+", lam.text)
        return _eval(m.group(1), env) if m else None

    def read(self, buf: Tuple, what: str) -> None:
        st = self.status.get(buf, _VISIBLE)
        if st != _VISIBLE:
            self.find(f"{what} reads {self.name(buf)}, which is {_STATE[st]}")
        self.in_use.add(buf)
        self.unread.discard(buf)

    def write(self, buf: Tuple, engine: str, what: str) -> None:
        if buf in self.writing:
            return  # one fill, several copies
        self.writing.add(buf)
        if buf in self.in_use:
            self.find(f"{what} writes {self.name(buf)} while it may still be read "
                      "(no __syncthreads() since its last read)")
        elif engine == "bulk" and buf in self.needs_fence:
            self.find(f"{what} writes {self.name(buf)} with no "
                      "fence_proxy_async_shared() after its last read")
        if buf in self.unread:
            self.find(f"{what} writes {self.name(buf)}, whose last fill is not read yet")
        if engine == "bulk" and self.barriers != "ready":
            self.find(f"{what} completes on an mbarrier not yet initialized and "
                      "published (mbar_init, fence_mbarrier_init, __syncthreads())")
        self.status[buf] = _IN_FLIGHT if engine == "bulk" else _ISSUED
        self.unread.add(buf)

    # -- statements -----------------------------------------------------------

    def run(self, stmts: List[Tuple]) -> None:
        for stmt in stmts:
            getattr(self, "_" + stmt[0])(*stmt[1:])

    def _block(self, stmts) -> None:
        self.scopes.append({})
        self.run(stmts)
        self.scopes.pop()

    def _if(self, cond, body, orelse) -> None:
        self.expression(cond)
        value = _eval(cond, self.env)
        if value is not None:
            self._block(body if value else (orelse or []))
        elif orelse is None:
            self._block(body)
        else:
            a, b = self.fork(), self.fork()
            a._block(body)
            b._block(orelse)
            self.merge(a, b)

    def _for(self, init, cond, step, body) -> None:
        self.scopes.append({})
        self.simple(init)
        for _ in range(1 if self.depth else _RUNS):
            if _eval(cond, self.env) is False:
                break
            self.expression(cond)
            self._block(body)
            self.simple(step)
        self.scopes.pop()

    def _simple(self, text) -> None:
        self.simple(text)

    def simple(self, text: str) -> None:
        if not text or text.startswith("static_assert"):
            return
        m = re.match(r"auto\s+(\w+)\s*=\s*\[[^\]]*\]\s*\(([^)]*)\)\s*\{", text)
        if m:
            lo = m.end() - 1
            body = text[lo + 1:_close(text, lo)]
            params = [re.findall(r"\w+", p)[-1] for p in _split_top(m.group(2)) if p]
            self.lambdas[m.group(1)] = _Lambda(params, _parse(body), body)
            return
        m = re.match(r"(?:\+\+(\w+)|(\w+)\+\+)$", text)
        if m:
            name = m.group(1) or m.group(2)
            if isinstance(self.env.get(name), int) and name not in _PINNED:
                self.env[name] += 1
            return
        if text.startswith("return"):
            self.expression(text[len("return"):])
            return
        m = self._PTR.match(text)
        if m:  # a pointer: into a buffer, or not
            self.expression(m.group(2), declaring=True)
            self.scopes[-1][m.group(1)] = self.buffer(m.group(2))
            return
        m = self._DECL.match(re.sub(r"^constexpr\s+", "const ", text))
        if m:
            for part in _split_top(m.group(1)):
                self.assign(part, declared=True)
            return
        if self._ASSIGN.match(text):
            self.assign(text, declared=False)
            return
        self.expression(text)

    def assign(self, text: str, declared: bool) -> None:
        m = self._ASSIGN.match(text)
        if not m:
            return
        name, rhs = m.group(1), m.group(2)
        if not declared and any(self.alias(i) is not None for i in
                                re.findall(r"\b(\w+)\b(?!\s*\[)", rhs)):
            # a captured pointer moved onto a buffer (no element read)
            self.scopes[0][name] = self.buffer(rhs)
            return
        self.expression(rhs)
        if name in _PINNED:
            return
        value = _eval(rhs, self.env)
        if isinstance(value, (bool, int)):
            self.env[name] = value
        else:
            self.env.pop(name, None)

    def expression(self, text: str, declaring: bool = False) -> None:
        """Reads through buffer pointers, then the calls, in order.  A
        pointer's declaration (``declaring``) reads nothing it points to."""
        calls = _calls(text)
        dests = [c[2][0] for c in calls if c[0] in _CP_ASYNC + (_BULK,) and c[2]]
        if not declaring:
            rest = text
            for d in dests:
                rest = rest.replace(d, " ", 1)
            for ident in dict.fromkeys(re.findall(r"\b[A-Za-z_]\w*\b", rest)):
                buf = self.alias(ident)
                if buf is not None and buf[0] != "bar":
                    self.read(buf, f"'{ident}'")
        for name, tmpl, args, _ in calls:
            self.call(name, tmpl, args, declaring)

    def call(self, name: str, tmpl: str, args: List[str], declaring: bool = False) -> None:
        if name in _CP_ASYNC or name == _BULK:
            for a in args[1:]:
                self.expression(a)
            buf = self.buffer(args[0])
            engine = "bulk" if name == _BULK else "cp.async"
            if buf is None:
                self.find(f"{name} into an address H07 cannot place ({args[0]!r})")
                return
            if name == _BULK and len(args) == 4:
                bar = self.buffer(args[3])
                if bar is None or bar[1] != buf[1]:
                    self.find(f"{name} into {self.name(buf)} completes on barrier "
                              f"{None if bar is None else bar[1]}, not its stage's own")
            self.write(buf, engine, name)
        elif name == "cp_async_commit":
            for b, st in self.status.items():
                if st == _ISSUED:
                    self.status[b] = _COMMITTED
        elif name == "cp_async_wait":
            if _eval(tmpl.strip("<>"), self.env) == 0:
                for b, st in self.status.items():
                    if st == _COMMITTED:
                        self.status[b] = _WAITED
        elif name == "__syncthreads":
            for b, st in self.status.items():
                if st == _WAITED:
                    self.status[b] = _VISIBLE
            self.needs_fence |= self.in_use
            self.in_use = set()
            if self.barriers == "fenced":
                self.barriers = "ready"
        elif name == "fence_proxy_async_shared":
            self.needs_fence = set()
        elif name == "mbar_init":
            self.barriers = "init"
            if _eval(args[1], self.env) != 1:
                self.find(f"mbar_init({', '.join(args)}): a fill has one arriving thread")
        elif name == "fence_mbarrier_init" and self.barriers == "init":
            self.barriers = "fenced"
        elif name == "mbar_arrive_expect_tx":
            bar = self.buffer(args[0])
            if bar is not None:
                self.fills[bar[1]] = self.fills.get(bar[1], 0) + 1
        elif name == "mbar_wait":
            bar, parity = self.buffer(args[0]), _eval(args[1], self.env)
            k = None if bar is None else bar[1]
            fills = self.fills.get(k, 0)
            if not fills:
                self.find(f"mbar_wait on barrier {k}, which no fill arrives on")
            elif parity != (fills - 1) & 1:
                self.find(f"mbar_wait on barrier {k} at parity {parity}: its pending "
                          f"fill completes phase {fills - 1}")
            buf = ("slots_of", k)
            if self.status.get(buf) == _IN_FLIGHT:
                self.status[buf] = _VISIBLE
        elif name in self.lambdas and not re.search(r"\bsmem\b", self.lambdas[name].text):
            lam = self.lambdas[name]
            for a in args:
                self.expression(a)
            outer = self.env
            self.env = dict(outer)
            for p, a in zip(lam.params, args):
                value = _eval(a, outer)
                if value is None:
                    self.env.pop(p, None)
                else:
                    self.env[p] = value
            self.scopes.append({})
            self.depth += 1
            if self.depth == 1:
                self.writing = set()
            self.run(lam.body)
            self.depth -= 1
            self.scopes.pop()
            self.env = {**outer, **{k: v for k, v in self.env.items()
                                    if k in outer and k not in lam.params}}
        elif name in self.lambdas and not declaring:  # an accessor's value: a read
            self.read((name, self.accessor_index(self.lambdas[name], args)), name)


def _check_fills(where: str, lam_text: str, findings: List[AuditFinding]) -> None:
    """A TMA fill expects exactly the bytes of its copies, on one barrier."""
    calls = _calls(lam_text)
    expects = [c for c in calls if c[0] == "mbar_arrive_expect_tx"]
    copies = [c for c in calls if c[0] == _BULK]
    if len(expects) != 1:
        findings.append(AuditFinding("GUST-H07", where, f"{len(expects)} "
                                     "mbar_arrive_expect_tx in one fill, not 1"))
        return
    bar, nbytes = expects[0][2][0], expects[0][2][1]
    if any(c[3] < expects[0][3] for c in copies):
        findings.append(AuditFinding("GUST-H07", where, "a bulk copy is issued before "
                                     "its barrier expects its bytes"))
    for c in copies:
        if c[2][3].strip() != bar.strip():
            findings.append(AuditFinding("GUST-H07", where, f"a bulk copy completes on "
                                         f"{c[2][3]!r}, the fill expects on {bar!r}"))
    total = sum((_terms(c[2][2]) for c in copies), Counter())
    if _terms(nbytes) != total:
        findings.append(AuditFinding(
            "GUST-H07", where, f"the fill expects {nbytes} bytes, its copies bring "
            + " + ".join(c[2][2] for c in copies)))


def _kernels(text: str):
    """``(name, template parameters, body)`` of each ``__global__`` function."""
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                         r"(\w+)\s*\(", text):
        t = re.search(r"template\s*<([^<>]*)>\s*$", text[:m.start()])
        lo = _close(text, m.end() - 1) + 1
        lo = text.index("{", lo)
        yield m.group(1), (t.group(1) if t else ""), text[lo + 1:_close(text, lo)]


def _instances(params: str, body: str):
    """Every assignment of the template's constants its static_asserts admit."""
    names = [n for n in _CONSTANTS if re.search(
        r"\bGather\s+G\b" if n == "LOCAL" else rf"\b{n}\b", params)]
    asserts = [_split_top(m.group(1))[0] for m in
               re.finditer(r"static_assert\s*\((.*?)\)\s*;", body, flags=re.S)]
    for values in itertools.product(*(_CONSTANTS[n] for n in names)):
        env = dict(zip(names, values))
        if all(_eval(a, env) is not False for a in asserts):
            yield env


@dataclasses.dataclass
class RingAudit:
    """GUST-H07 over a set of sources: what each holds, and the findings."""

    checked: Dict[str, str]
    findings: List[AuditFinding]

    def report(self) -> str:
        lines = ["asynchronous copies (GUST-H07):"]
        lines += [f"  {name}: {what}" for name, what in self.checked.items()]
        lines += [str(f) for f in self.findings]
        return "\n".join(lines)


def audit_rings(sources: Optional[Iterable[str]] = None) -> RingAudit:
    """GUST-H07 over ``sources`` (paths; default every ``.cu`` and ``.cuh``
    of ``kernels/csrc``), from their text alone: no ``nvcc``, no card."""
    if sources is None:
        from ..kernels._build import CSRC

        sources = sorted(str(p) for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    checked: Dict[str, str] = {}
    findings: List[AuditFinding] = []
    for path in sources:
        fname = os.path.basename(str(path))
        with open(path, encoding="utf-8") as f:
            text = _strip_comments(f.read())
        if re.search(r"asm[^;]*\"\s*(?:cp\.async|mbarrier)", text) and \
                not re.search(r"void\s+cp_async4\s*\(", text):
            findings.append(AuditFinding("GUST-H07", fname, "an asynchronous copy in "
                                         "inline PTX outside gust_common.cuh's primitives"))
        kernels = list(_kernels(text))
        if not kernels:
            inc = re.findall(r'#include\s+"(\w+\.cuh)"', text)
            checked[fname] = ("defines the copy primitives, no kernel"
                              if re.search(r"void\s+cp_async4\s*\(", text)
                              else "no kernel of its own" + (
                                  f" (instances of {', '.join(inc)})" if inc else ""))
            continue
        issuing = []
        for name, params, body in kernels:
            if not re.search(rf"\b(?:{'|'.join(_CP_ASYNC + (_BULK,))})\s*\(", body):
                continue
            instances = list(_instances(params, body))
            kinds = sorted({c for c in _CP_ASYNC + (_BULK,) if re.search(rf"\b{c}\s*\(", body)})
            issuing.append(f"{name} ({', '.join(kinds)}; {len(instances)} instances)")
            for env in instances:
                where = f"{fname}:{name}<" + ", ".join(f"{k}={v}" for k, v in env.items()) + ">"
                sim = _Sim(where, {**env, **_PINNED}, findings)
                sim.run(_parse(body))
                for lname, lam in sim.lambdas.items():
                    if re.search(rf"\b{_BULK}\s*\(", lam.text):
                        _check_fills(f"{fname}:{name}/{lname}", lam.text, findings)
        checked[fname] = (f"{len(kernels)} kernel(s); " +
                          ("; ".join(issuing) if issuing else "no asynchronous copy issued"))
    unique = list(dict.fromkeys(findings))
    return RingAudit(checked, unique)


@dataclasses.dataclass
class AuditResult:
    reports: List[KernelReport]
    plans: List[Dict]
    findings: List[AuditFinding]
    rings: Optional[RingAudit] = None

    def report(self) -> str:
        """The printable audit: every function, every plan, every source,
        every finding."""
        lines = ["kernels (ptxas):"] + [f"  {r}" for r in self.reports]
        if self.rings is not None:
            lines += [f"  {line}" for line in self.rings.report().splitlines()
                      if not line.startswith("[")]
        lines.append(f"launch plans: {len(self.plans)}")
        for p in self.plans:
            lines.append(f"  {plan_tag(p)}: {p['ctas_per_sm']} CTAs per SM, "
                         f"{p['smem_bytes']} bytes dynamic smem, grid "
                         + (f"({p['grid_x']}, {p['grid_y']})" if "grid_x" in p
                            else f"{p['grid']}"))
        lines += [str(f) for f in self.findings]
        lines.append(f"audit: {len(self.findings)} finding(s)")
        return "\n".join(lines)

    def to_dict(self) -> Dict:
        regs = {}
        for r in self.reports:
            regs[r.library] = max(regs.get(r.library, 0), r.registers)
        return {"libraries": sorted(regs), "functions": len(self.reports),
                "max_registers": regs, "plans": len(self.plans),
                "rings": None if self.rings is None else self.rings.checked,
                "findings": [str(f) for f in self.findings]}


def audit_kernels(libraries: Optional[Iterable[str]] = None,
                  plans: Iterable[Dict] = (),
                  sources: Optional[Iterable[str]] = None) -> AuditResult:
    """Audit every library in ``libraries`` (default: all of
    ``kernels._build.SOURCES``; built first where needed) from its ptxas
    report, each launch plan in ``plans`` against its instance, and the
    asynchronous copies of ``sources`` (:func:`audit_rings`)."""
    from ..kernels import _build

    names = list(_build.SOURCES if libraries is None else libraries)
    reports = [r for name in names for r in parse_ptxas(name, _build.ptxas_report(name))]
    plans = list(plans)
    findings = audit_reports(reports)
    for p in plans:
        findings += audit_plan(p, reports)
    rings = audit_rings(sources)
    return AuditResult(reports, plans, findings + rings.findings, rings)


def default_plans(device="cuda") -> List[Dict]:
    """The launch plans of every spread library on a seeded stream (each
    value type at int32 indices, and float32 at int16; B = 1 and 8) and
    the SpGEMM kernel's, on the card: what ``python -m
    repro_torch.analysis audit`` audits by itself."""
    import torch

    from ..core.packing import pack_schedule, resolve_device
    from ..core.scheduler import schedule
    from ..data.matrices import synth_uniform
    from ..kernels.gust_spgemm import spgemm_launch_plan
    from ..kernels.gust_spmv import _SPREAD_LIBS, spread_launch_plan
    from ..kernels.ops import _prep_x

    device = resolve_device(device)
    coo = synth_uniform(4096, 2e-3, seed=0)
    sched = schedule(coo, 256, workers=1)
    plans = []
    for vdt, idt in (("float32", "int32"), ("bfloat16", "int32"), ("int8", "int32"),
                     ("float32", "int16")):
        art = pack_schedule(sched, 8, vdt, idt, device=device)
        for b in (1, 8):
            xp = _prep_x(torch.zeros(coo.shape[1], b, device=device), coo.shape[1], 256)
            for gather, pipeline in _SPREAD_LIBS:
                cols = art.col_loc if gather == "local" else art.col_blk
                plans.append(spread_launch_plan(art.m_blk, cols, art.row_blk, xp, l=256,
                                                c_blk=8, gather=gather, pipeline=pipeline))
    plans.append(spgemm_launch_plan(device))
    return plans
