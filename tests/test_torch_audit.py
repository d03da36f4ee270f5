"""The Hopper resource audit (``repro_torch.analysis.kernel_audit``) on the
CPU: each ``GUST-Hxx`` rule fires on a canned ``ptxas -v`` report or a
doctored launch plan and is silent on clean ones.  The reports are in
the format ``nvcc -Xptxas=-v`` gives for ``sm_90a`` (entry names mangled
as the port's kernels are); the plans are what ``spread_launch_plan`` and
``spgemm_launch_plan`` return on an H100 (132 SMs).  The audit of the
real builds and plans runs on the card (``tests/test_torch_gpu.py``).
"""

import os
import subprocess
import sys

import pytest

from repro_torch.analysis import kernel_audit as KA

NS = "_ZN45_GLOBAL__N__556e93c9_12_gust_spmv_cu_3acca396"
PARTIALS_F32_B1 = f"{NS}15spread_partialsIfiLb0ELi1ELNS_6GatherE0ELi0ELi0EEEvPKT_PKT0_S7_PKiPKfSB_Pfiiiiiii"
PARTIALS_F32_B8 = f"{NS}15spread_partialsIfiLb0ELi8ELNS_6GatherE0ELi0ELi0EEEvPKT_PKT0_S7_PKiPKfSB_Pfiiiiiii"
FOLD = f"{NS}11spread_foldILb0EEEvPKfPfPKiiiii"
TILES = "_ZN47_GLOBAL__N__e20fef3f_14_gust_spgemm_cu_3e4ee51816row_tiles_kernelEPKfPKiPKxS3_S5_S3_S1_S3_PfiiixPyS7_"
SCAN = "_ZN47_GLOBAL__N__e20fef3f_14_gust_spgemm_cu_3e4ee51815row_scan_kernelEPKiiPKhPiS4_"


def entry(name, regs, smem=0, spills=(0, 0), stack=0):
    used = f"ptxas info    : Used {regs} registers, used 1 barriers" + (
        f", {smem} bytes smem" if smem else "")
    return "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        f"    {stack} bytes stack frame, {spills[0]} bytes spill stores, "
        f"{spills[1]} bytes spill loads",
        used,
        "ptxas info    : Compile time = 98.141 ms",
    ])


def spmv_report(**doctor):
    """A canned report of the resident single-buffered library: two
    ``spread_partials`` instances (float32 values, int32 indices, B=1 and
    B=8) and the fold; ``doctor`` overrides one instance's numbers."""
    b1 = dict(regs=36)
    b1.update(doctor)
    return "\n".join(["ptxas info    : 0 bytes gmem", entry(FOLD, 32),
                      entry(PARTIALS_F32_B1, **b1), entry(PARTIALS_F32_B8, 52)])


def spgemm_report(regs=94):
    return "\n".join([entry(TILES, regs), entry(SCAN, 32, smem=528)])


def spread_plan(**doctor):
    """A B=1 float32 plan of the resident single-buffered kernel as the
    H100 gives it for crankseg_2's balanced stream."""
    plan = {"ctas_per_sm": 6, "grid_x": 792, "grid_y": 1, "smem_bytes": 33_792,
            "stage_tiles": 0, "chunk_cycles": 8, "stream_stages": 0,
            "partial_bytes": 0,
            "launch": {"library": "gust_spmv", "kernel": "spread_partials", "threads": 256,
                       "sms": 132, "value_dtype": "float32", "index_dtype": "int32",
                       "gather": "resident", "pipeline": "single", "b": 1,
                       "t_blk": 32_000, "l": 256}}
    for k, v in doctor.items():
        (plan["launch"] if k in plan["launch"] else plan)[k] = v
    return plan


def spgemm_plan(**doctor):
    plan = {"ctas_per_sm": 4, "grid": 528, "smem_bytes": 16_384, "warps_per_cta": 4,
            "n_t": 1024, "launch": {"library": "gust_spgemm", "kernel": "row_tiles_kernel",
                                    "threads": 128, "sms": 132}}
    plan.update(doctor)
    return plan


def reports(spmv=None, spgemm=None):
    return (KA.parse_ptxas("gust_spmv", spmv or spmv_report())
            + KA.parse_ptxas("gust_spgemm", spgemm or spgemm_report()))


def rules(findings):
    return sorted({f.rule for f in findings})


def test_parse_reads_every_entry_and_its_instance():
    got = reports()
    assert [(r.library, r.name, r.registers, r.static_smem) for r in got] == [
        ("gust_spmv", "spread_fold", 32, 0), ("gust_spmv", "spread_partials", 36, 0),
        ("gust_spmv", "spread_partials", 52, 0), ("gust_spgemm", "row_tiles_kernel", 94, 0),
        ("gust_spgemm", "row_scan_kernel", 32, 528)]
    assert got[1].template == "fiLb0ELi1ELNS_6GatherE0ELi0ELi0E"
    assert got[1].template == KA.spread_instance(spread_plan()["launch"], 0)
    assert got[0].template == "Lb0E" and got[3].template == ""


def test_clean_reports_and_plans_have_no_finding():
    reps = reports()
    assert KA.audit_reports(reps) == []
    for plan in (spread_plan(), spread_plan(b=8, ctas_per_sm=4, grid_x=528), spgemm_plan()):
        assert KA.audit_plan(plan, reps) == [], plan


@pytest.mark.parametrize("rule,doctor", [
    ("GUST-H01", dict(regs=256)),
    ("GUST-H02", dict(spills=(16, 16), stack=16)),
    ("GUST-H03", dict(smem=49_153)),
], ids=["registers", "spills", "static_smem"])
def test_each_kernel_rule_fires_on_its_report(rule, doctor):
    found = KA.audit_reports(reports(spmv=spmv_report(**doctor)))
    assert rules(found) == [rule]
    assert all("spread_partials<fiLb0ELi1E" in f.where for f in found)


def test_a_spill_in_a_device_function_fires():
    text = spmv_report() + "\n" + "\n".join([
        "ptxas info    : Function properties for _Z6helperv",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"])
    assert rules(KA.audit_reports(reports(spmv=text))) == ["GUST-H02"]


@pytest.mark.parametrize("rule,plan,report", [
    ("GUST-H04", spread_plan(smem_bytes=232_449), None),
    ("GUST-H04", spread_plan(smem_bytes=40_000), None),  # 6 x 41 KiB > 228 KiB an SM
    ("GUST-H04", spread_plan(smem_bytes=200_000, ctas_per_sm=1, grid_x=132),
     dict(smem=40_000)),  # static + dynamic > 227 KiB a CTA
    ("GUST-H05", spread_plan(ctas_per_sm=8, smem_bytes=1024), None),  # 40 x 8 x 8 warps
    ("GUST-H05", spread_plan(), dict(regs=64)),  # the instance's own registers
    ("GUST-H06", spread_plan(grid_x=32_001), None),  # more CTAs than blocks
    ("GUST-H06", spread_plan(grid_x=0), None),
    ("GUST-H06", spread_plan(grid_x=1000), None),  # more than 6 x 132 resident
    ("GUST-H06", spread_plan(grid_y=2), None),  # column tiles for B=1
    ("GUST-H06", spgemm_plan(grid=529), None),
    ("GUST-H05", spgemm_plan(ctas_per_sm=6, grid=792), None),  # 96 x 4 warps x 6
], ids=["cta_smem", "sm_smem", "static_plus_dynamic", "registers_ctas",
        "instance_registers", "grid_past_blocks", "empty_grid", "grid_past_resident",
        "grid_y", "spgemm_grid", "spgemm_registers"])
def test_each_plan_rule_fires_on_a_doctored_plan(rule, plan, report):
    reps = reports(spmv=spmv_report(**report) if report else None)
    assert rules(KA.audit_plan(plan, reps)) == [rule]


def test_a_plan_without_its_instance_is_a_finding():
    plan = spread_plan(value_dtype="bfloat16")  # no bf16 instance in the canned report
    found = KA.audit_plan(plan, reports())
    assert rules(found) == ["GUST-H05"] and "no ptxas report" in found[0].message


def test_result_report_and_summary():
    reps = reports(spmv=spmv_report(regs=300))
    plans = [spread_plan(), spgemm_plan(grid=1)]
    result = KA.AuditResult(reps, plans, KA.audit_reports(reps)
                            + [f for p in plans for f in KA.audit_plan(p, reps)])
    text = result.report()
    assert "audit: 3 finding(s)" in text and "GUST-H01" in text and "GUST-H06" in text
    summary = result.to_dict()
    assert summary["max_registers"] == {"gust_spmv": 300, "gust_spgemm": 94}
    assert summary["plans"] == 2 and len(summary["findings"]) == 3


def test_audit_cli_needs_the_toolkit_without_one():
    """Here (no ``nvcc``) the audit cannot build the libraries it reads:
    the CLI exits nonzero and says why; it never reports a clean audit."""
    from repro_torch.kernels import _build

    if any(_build._report_path(_build._lib_path(n)).exists() for n in _build.SOURCES):
        pytest.skip("a build exists here")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "audit"],
                         capture_output=True, text=True, cwd=root,
                         env=dict(os.environ, CUDA_HOME="/nonexistent-toolkit"))
    assert out.returncode != 0 and "audit: 0 finding(s)" not in out.stdout
