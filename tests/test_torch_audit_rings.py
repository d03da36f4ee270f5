"""GUST-H07 (``repro_torch.analysis.kernel_audit.audit_rings``): the
asynchronous copies of the CUDA sources, checked from their text alone.

The tree gives no finding; each mutated copy of ``gust_spread.cuh``
(one edit that breaks the ring or the ``cp.async`` stages) gives at least
one.  The card tests hold every ring instance bitwise to the register
one; this is the static twin, which runs without ``nvcc``."""

import os
import subprocess
import sys

import pytest

from repro_torch.analysis import kernel_audit as KA
from repro_torch.kernels._build import CSRC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPREAD = str(CSRC / "gust_spread.cuh")

#: name -> (text in gust_spread.cuh, its replacement, words of the finding)
MUTANTS = {
    # the wait of take_chunk removed: the stream stage is read in flight
    "take_chunk_without_mbar_wait": (
        "    mbar_wait(bars + u % NR, (u / NR) & 1);\n", "", "in flight"),
    # the refill issues into the next stage, still to be read
    "refill_into_a_stage_still_to_be_read": (
        "        issue(u + RING);", "        issue(u + 1);", "not read yet"),
    # the block-top cp_async_wait removed: the tiles are read uncompleted
    "block_top_without_cp_async_wait": (
        "        cp_async_wait<0>();\n        __syncthreads();  // block t's",
        "        __syncthreads();  // block t's", "not waited on"),
    "first_table_row_without_cp_async_wait": (
        "    cp_async_commit();\n    cp_async_wait<0>();\n  }",
        "    cp_async_commit();\n  }", "not waited on"),
    "block_top_without_barrier": (
        "        cp_async_wait<0>();\n        __syncthreads();  // block t's",
        "        cp_async_wait<0>();\n        // block t's", "not yet published"),
    "refill_before_the_product_barrier": (
        "    __syncthreads();  // every product of the chunk is in the buffer\n"
        "    if constexpr (RING > 0) {\n"
        "      // every thread has read stage u: refill it with chunk u + RING\n"
        "      if (j == 0 && u + RING < units) {\n"
        "        fence_proxy_async_shared();\n"
        "        issue(u + RING);\n"
        "      }\n"
        "    }",
        "    if constexpr (RING > 0) {\n"
        "      if (j == 0 && u + RING < units) {\n"
        "        fence_proxy_async_shared();\n"
        "        issue(u + RING);\n"
        "      }\n"
        "    }\n"
        "    __syncthreads();  // every product of the chunk is in the buffer",
        "may still be read"),
    "refill_without_proxy_fence": (
        "        fence_proxy_async_shared();\n        issue(u + RING);",
        "        issue(u + RING);", "fence_proxy_async_shared"),
    "expected_bytes_short_of_the_copies": (
        "mbar_arrive_expect_tx(bar, nv + 2 * ni);",
        "mbar_arrive_expect_tx(bar, nv + ni);", "its copies bring"),
    "wait_at_the_wrong_parity": ("(u / NR) & 1)", "u & 1)", "parity"),
    "double_buffer_prefetch_into_the_stage_being_read": (
        "fetch_tiles(slot ^ 1, n_next);", "fetch_tiles(slot, n_next);", "not read yet"),
}


def _mutant(tmp_path, name):
    old, new, _ = MUTANTS[name]
    with open(SPREAD, encoding="utf-8") as f:
        text = f.read()
    assert text.count(old) == 1, f"{name}: the edited text is not in the template once"
    path = tmp_path / "gust_spread.cuh"
    path.write_text(text.replace(old, new), encoding="utf-8")
    return str(path)


def test_tree_has_no_finding_and_names_every_source():
    result = KA.audit_rings()
    assert result.findings == [], result.report()
    sources = sorted(f.name for f in CSRC.iterdir() if f.suffix in (".cu", ".cuh"))
    assert sorted(result.checked) == sources
    assert "4 instances" in result.checked["gust_spread.cuh"]
    for name in ("bulk_copy_g2s", "cp_async16", "cp_async4"):
        assert name in result.checked["gust_spread.cuh"]
    # the SpGEMM and Buffer Filler kernels issue no asynchronous copy: said, not skipped
    for src in ("gust_spgemm.cu", "gather_fill.cu"):
        assert result.checked[src].endswith("no asynchronous copy issued"), result.checked
    assert "GUST-H07" in KA.RULES


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mutated_template_gives_a_finding(tmp_path, name):
    result = KA.audit_rings([_mutant(tmp_path, name)])
    assert result.findings, f"{name}: no finding"
    assert all(f.rule == "GUST-H07" for f in result.findings)
    words = MUTANTS[name][2]
    assert any(words in f.message for f in result.findings), result.report()


def test_audit_kernels_reports_h07(tmp_path):
    """``audit_kernels`` (the CLI's and the smoke's audit) carries H07's
    findings and the per-source summary."""
    path = _mutant(tmp_path, "take_chunk_without_mbar_wait")
    result = KA.audit_kernels(libraries=[], sources=[path])
    assert [f.rule for f in result.findings] and {f.rule for f in result.findings} == {
        "GUST-H07"}
    assert result.to_dict()["rings"] == result.rings.checked
    assert "asynchronous copies (GUST-H07)" in result.report()
    clean = KA.audit_kernels(libraries=[])
    assert clean.findings == [] and "gust_spread.cuh" in clean.to_dict()["rings"]


def test_rings_cli_runs_without_the_toolkit(tmp_path):
    env = dict(os.environ, CUDA_HOME="/nonexistent-toolkit", PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "audit", "--rings"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "audit: 0 finding(s)" in out.stdout
