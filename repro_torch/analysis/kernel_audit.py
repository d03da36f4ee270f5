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
K02 (the Pallas double-buffer discipline) has no counterpart yet.

Entry point: :func:`audit_kernels` → :class:`AuditResult`;
``python -m repro_torch.analysis audit`` prints its report and exits
nonzero on any finding.  It builds what is not built (``nvcc``), so it
runs where the card and the toolkit are.
"""

from __future__ import annotations

import dataclasses
import re
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


@dataclasses.dataclass
class AuditResult:
    reports: List[KernelReport]
    plans: List[Dict]
    findings: List[AuditFinding]

    def report(self) -> str:
        """The printable audit: every function, every plan, every finding."""
        lines = ["kernels (ptxas):"] + [f"  {r}" for r in self.reports]
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
                "findings": [str(f) for f in self.findings]}


def audit_kernels(libraries: Optional[Iterable[str]] = None,
                  plans: Iterable[Dict] = ()) -> AuditResult:
    """Audit every library in ``libraries`` (default: all of
    ``kernels._build.SOURCES``; built first where needed) from its ptxas
    report, and each launch plan in ``plans`` against its instance."""
    from ..kernels import _build

    names = list(_build.SOURCES if libraries is None else libraries)
    reports = [r for name in names for r in parse_ptxas(name, _build.ptxas_report(name))]
    plans = list(plans)
    findings = audit_reports(reports)
    for p in plans:
        findings += audit_plan(p, reports)
    return AuditResult(reports, plans, findings)


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
