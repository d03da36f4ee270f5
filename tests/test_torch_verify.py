"""Port parity of the artifact verifier (``repro_torch.analysis.verify``)
against ``repro.analysis.verify``, and its hooks (``GustPlan.verify``,
``PlanStore(verify="load")``, ``GustServeConfig.store_verify``, the CLI).

Mutation tests as the reference's own (``tests/test_analysis.py``): each
seeds exactly one corruption into a clean artifact's leaves and exactly
that rule fires — applied to the reference's leaves (numpy) and to the
port's (torch tensors) of the same matrix, whose findings must be equal
field for field (rule, severity, leaf, message, indices, count,
section).  Clean artifacts give zero findings over padded/ragged ×
float32/bfloat16/int8 × resident/local, and at int16 indices.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis.verify import RULES as REF_RULES
from repro.analysis.verify import verify as ref_verify
from repro.core.formats import COOMatrix as RefCOO
from repro.core.plan import plan as ref_plan

import repro_torch
from repro_torch.analysis.verify import RULES, verify
from repro_torch.core.convert import to_numpy_leaves
from repro_torch.core.formats import COOMatrix
from repro_torch.core.plan_store import PlanStore

torch.set_num_threads(1)

#: The module itself (the package's lazy ``verify`` export is the function).
port_verify_module = importlib.import_module("repro_torch.analysis.verify")
L = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coo_args(m=96, n=80, nnz=600, seed=3):
    r = np.random.default_rng(seed)
    idx = r.choice(m * n, size=nnz, replace=False)
    rows, cols = idx // n, idx % n
    vals = r.standard_normal(nnz).astype(np.float32)
    order = np.argsort(rows * n + cols)
    return ((m, n), rows[order].astype(np.int64), cols[order].astype(np.int64),
            vals[order])


def plans(seed=3, **kw):
    """(reference plan, port plan on the CPU) of the same matrix and knobs."""
    args = _coo_args(seed=seed)
    return (ref_plan(RefCOO(*args), l=L, cache=None, **kw),
            repro_torch.plan(COOMatrix(*args), l=L, cache=None, device="cpu", **kw))


def as_tuples(findings):
    return [dataclasses.astuple(f) for f in findings]


def ref_leaves(p):
    spec = p.to_spec()
    return {k: np.array(np.asarray(v)) for k, v in spec["leaves"].items()}, tuple(spec["meta"])


def port_leaves(p):
    """The port's leaves as numpy copies to mutate (bf16 as its bits),
    the meta, and the names of the bf16 leaves."""
    spec = p.to_spec()
    bf16 = {k for k, v in spec["leaves"].items() if v.dtype == torch.bfloat16}
    return to_numpy_leaves(spec["leaves"]), tuple(spec["meta"]), bf16


def to_torch(leaves, bf16):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in leaves.items()}
    return {k: t.view(torch.bfloat16) if k in bf16 else t for k, t in out.items()}


def bits(a):
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def both(rp, tp, mutate):
    """Apply ``mutate`` to each package's leaves; return (reference
    findings, port findings on torch leaves)."""
    (rl, rmeta), (tl, tmeta, bf16) = ref_leaves(rp), port_leaves(tp)
    assert rmeta == tmeta
    for k in rl:
        assert np.array_equal(bits(rl[k]), tl[k]), k
    mutate(rl, rmeta)
    mutate(tl, tmeta)
    return ref_verify(rl, rmeta), verify(to_torch(tl, bf16), tmeta)


def test_rule_table_is_the_reference_table():
    assert RULES == REF_RULES
    assert port_verify_module.verify_artifact is verify


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("gather", ["resident", "local"])
def test_clean_artifacts_have_no_finding(layout, value_dtype, gather):
    rp, tp = plans(layout=layout, value_dtype=value_dtype, gather=gather)
    assert ref_verify(rp) == [] and tp.verify() == [] and verify(tp.artifact) == []
    spec = tp.to_spec()
    assert verify(spec["leaves"], spec["meta"]) == []
    if value_dtype == "bfloat16":  # the leaf keeps its dtype; the verifier widens
        assert spec["leaves"]["m_blk"].dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [dict(load_balance=True),
                                dict(load_balance=True, layout="ragged", value_dtype="int8"),
                                dict(index_dtype="int16"),
                                dict(index_dtype="int16", layout="ragged",
                                     value_dtype="bfloat16")],
                         ids=["balanced", "balanced_ragged_int8", "int16", "int16_ragged_bf16"])
def test_clean_balanced_and_int16_artifacts(kw):
    rp, tp = plans(seed=7, **kw)
    assert ref_verify(rp) == [] and tp.verify() == []
    if kw.get("index_dtype") == "int16":
        assert tp.artifact.col_blk.dtype == torch.int16


# ---------------------------------------------------------------------------
# one mutation -> exactly one rule, the same findings in both packages
# ---------------------------------------------------------------------------


def _all_padding_block_row(leaves, c_blk):
    m = leaves["m_blk"]
    t_blk = m.shape[0] // c_blk
    ts = np.flatnonzero((m == 0).reshape(t_blk, -1).all(axis=1))
    assert ts.size, "no all-padding block in the stream"
    return int(ts[0]) * c_blk


def p01(leaves, meta):
    m, seg = leaves["m_blk"], leaves["seg_blk"]
    c_pad, c_blk = meta[2], meta[5]
    row_zero = (m == 0).all(axis=1)
    target = None
    for r in range(m.shape[0]):
        if (row_zero[r] and r % c_pad != 0 and row_zero[r - 1]
                and (r - 1) // c_pad == r // c_pad and seg[r // c_blk, 0] == 0):
            target = r
    assert target is not None
    m[target, 0] = 1.0 if m.dtype != np.int16 else 0x3F80  # bf16 bits of 1.0


def p02(leaves, meta):
    r = _all_padding_block_row(leaves, meta[5])
    leaves["col_blk"][r, 0] = L - 1
    leaves["col_loc"][r, 0] = L - 1


def p03(leaves, meta):
    leaves["row_blk"][_all_padding_block_row(leaves, meta[5]), 0] = 3


def p04(leaves, meta):
    m, col = leaves["m_blk"], leaves["col_blk"]
    assert meta[4]
    for r, j in zip(*np.nonzero(m)):
        off = col[r, j] % L
        if off == j and (off + 1) % L != 0 and off + 1 != L - 1 - j:
            leaves["col_blk"][r, j] += 1
            leaves["col_loc"][r, j] += 1
            return
    raise AssertionError("no slot to move")


def p05(leaves, meta):
    leaves["col_blk"] = leaves["col_blk"].astype(np.int64)


def p05_int16(leaves, meta):  # index leaves that disagree: int16 beside int32
    leaves["col_blk"] = leaves["col_blk"].astype(np.int16)


def p06(leaves, meta):
    leaves["block_starts"][1] = leaves["block_starts"][0]


def p07(leaves, meta):
    b = int(leaves["block_starts"][1])
    bw = leaves["block_window"]
    bw[b - 1], bw[b] = bw[b], bw[b - 1]


def _row_with_two_segments(seg):
    for t in range(seg.shape[0]):
        if (seg[t] > 0).sum() >= 2:
            return t
    raise AssertionError("no seg_blk row with two nonzero segments")


def p08(leaves, meta):
    seg = leaves["seg_blk"]
    t = _row_with_two_segments(seg)
    a, b = np.flatnonzero(seg[t] > 0)[:2]
    seg[t, a], seg[t, b] = seg[t, b], seg[t, a]


def p09(leaves, meta):
    assert meta[6] >= 2
    leaves["seg_blk"][0, meta[6] - 1] = -(-meta[3][1] // L)


def p10(leaves, meta):
    m, col, loc, seg = leaves["m_blk"], leaves["col_blk"], leaves["col_loc"], leaves["seg_blk"]
    c_blk, s_blk = meta[5], meta[6]
    for r, j in zip(*np.nonzero(m)):
        cur = loc[r, j] // L
        alt = cur + 1 if cur + 1 < s_blk else cur - 1
        if alt >= 0 and seg[r // c_blk, alt] != col[r, j] // L:
            loc[r, j] = alt * L + loc[r, j] % L
            return
    raise AssertionError("no slot to remap")


def p11(leaves, meta):
    leaves["scale_blk"] = leaves["scale_blk"].astype(np.float64)


def p12(leaves, meta):
    leaves["scale_blk"][_all_padding_block_row(leaves, meta[5]) // meta[5]] = 2.0


def p13(leaves, meta):
    m, c_blk = leaves["m_blk"], meta[5]
    t_blk = m.shape[0] // c_blk
    t = int(np.flatnonzero((m.reshape(t_blk, -1) != 0).any(axis=1))[0])
    blk = m[t * c_blk:(t + 1) * c_blk]
    peak = np.abs(blk) == 127
    blk[peak] = (np.sign(blk[peak]) * 126).astype(np.int8)


def p14(leaves, meta):
    m, row = leaves["m_blk"], leaves["row_blk"]
    for r in range(m.shape[0]):
        real = np.flatnonzero(m[r] != 0)
        if real.size >= 2:
            row[r, real[1]] = row[r, real[0]]
            return
    raise AssertionError("no row with two real slots")


def p15(leaves, meta):
    leaves["row_perm"][0] = leaves["row_perm"][1]


def p17(leaves, meta):
    r, j = next(zip(*np.nonzero(leaves["m_blk"])))
    leaves["col_blk"][r, j] += -(-meta[3][1] // L) * L


def p03_ragged(leaves, meta):
    r, j = np.argwhere(leaves["m_blk"] == 0)[0]
    leaves["row_blk"][r, j] = 2


MUTATIONS = [
    ("GUST-P01", p01, dict(layout="padded")),
    ("GUST-P01", p01, dict(layout="padded", value_dtype="bfloat16")),
    ("GUST-P02", p02, dict(layout="padded")),
    ("GUST-P03", p03, dict(layout="padded")),
    ("GUST-P03", p03_ragged, dict(layout="ragged")),
    ("GUST-P04", p04, dict(layout="padded")),
    ("GUST-P05", p05, dict(layout="padded")),
    ("GUST-P05", p05_int16, dict(layout="ragged")),
    ("GUST-P06", p06, dict(layout="ragged")),
    ("GUST-P07", p07, dict(layout="ragged")),
    ("GUST-P08", p08, dict(layout="padded")),
    ("GUST-P09", p09, dict(layout="padded")),
    ("GUST-P10", p10, dict(layout="padded")),
    ("GUST-P11", p11, dict(layout="padded", value_dtype="int8")),
    ("GUST-P12", p12, dict(layout="padded", value_dtype="int8")),
    ("GUST-P13", p13, dict(layout="padded", value_dtype="int8")),
    ("GUST-P14", p14, dict(layout="padded")),
    ("GUST-P14", p14, dict(layout="ragged", value_dtype="int8")),
    ("GUST-P15", p15, dict(layout="padded")),
    ("GUST-P17", p17, dict(layout="padded")),
]


@pytest.mark.parametrize("rule,mutate,kw", MUTATIONS,
                         ids=[f"{r}-{f.__name__}-{'-'.join(k.values())}"
                              for r, f, k in MUTATIONS])
def test_each_mutation_fires_its_rule_with_the_reference_findings(rule, mutate, kw):
    rp, tp = plans(**dict(dict(value_dtype="float32"), **kw))
    want, got = both(rp, tp, mutate)
    assert sorted({f.rule for f in want}) == [rule]
    assert as_tuples(got) == as_tuples(want)
    assert [str(f) for f in got] == [str(f) for f in want]


def test_canonical_coo_rule():
    cases = [((4, 4), [0, 1, 2], [1, 0, 3], [1.0, 2.0, 3.0]),  # canonical
             ((4, 4), [0, 0, 2], [1, 1, 3], [1.0, 2.0, 3.0]),  # duplicate
             ((4, 4), [0, 1], [1, 2], [1.0, 0.0]),  # explicit zero
             ((4, 4), [0, 5], [1, 2], [1.0, 2.0])]  # out of bounds: built unchecked
    for shape, r, c, v in cases:
        args = (np.array(r, np.int64), np.array(c, np.int64), np.array(v, np.float32))
        if max(r) >= shape[0]:
            port, ref = (object.__new__(COOMatrix), object.__new__(RefCOO))
            for obj in (port, ref):
                object.__setattr__(obj, "shape", shape)
                for name, a in zip(("rows", "cols", "vals"), args):
                    object.__setattr__(obj, name, a)
        else:
            port, ref = COOMatrix(shape, *args), RefCOO(shape, *args)
        assert as_tuples(verify(port)) == as_tuples(ref_verify(ref))
    assert [f.rule for f in verify(COOMatrix((4, 4), *(
        np.array([0, 0]), np.array([1, 1]), np.array([1.0, 2.0], np.float32))))] == ["GUST-P16"]


def test_wrong_inputs_raise_like_the_reference():
    with pytest.raises(ValueError, match="meta is required"):
        verify({"m_blk": torch.zeros(1, L)})
    with pytest.raises(TypeError, match="GustPlan"):
        verify(3)


# ---------------------------------------------------------------------------
# hooks: the store's verify-on-load, serving's store_verify, the CLI
# ---------------------------------------------------------------------------


def _flip_and_put(store, key, rule="GUST-P03"):
    """Re-put ``key`` with one leaf corrupted so that the file still
    parses: a padding slot's adder row (GUST-P03) or a repeated
    ``row_perm`` entry (GUST-P15)."""
    spec = store.get(key)["spec"]
    bad = {k: v.clone() for k, v in spec["leaves"].items()}
    if rule == "GUST-P03":
        bad["row_blk"][_all_padding_block_row(to_numpy_leaves(bad), 8), 0] = 3
    else:
        bad["row_perm"][0] = bad["row_perm"][1]
    assert sorted({f.rule for f in verify(bad, spec["meta"])}) == [rule]
    store.put(key, {"leaves": bad, "meta": spec["meta"], "config": spec["config"]})


def test_store_verify_on_load(tmp_path):
    args = _coo_args()
    store = PlanStore(str(tmp_path / "store"))
    p = repro_torch.plan(COOMatrix(*args), l=L, layout="padded", cache=None, store=store,
                         device="cpu")
    p.artifact  # write-behind
    key = store.keys()[0]
    checking = PlanStore(str(tmp_path / "store"), verify="load")
    assert checking.get(key) is not None and checking.corrupt == 0

    _flip_and_put(store, key)
    assert PlanStore(str(tmp_path / "store")).get(key) is not None  # off: served
    before = (checking.corrupt, checking.misses, checking.hits)
    assert checking.get(key) is None  # load: a counted corrupt miss, never raised
    assert (checking.corrupt, checking.misses, checking.hits) == (
        before[0] + 1, before[1] + 1, before[2])

    # a plan through the verifying store is packed fresh, never the bad bits
    p2 = repro_torch.plan(COOMatrix(*args), l=L, layout="padded", cache=None,
                          store=checking, device="cpu")
    assert not p2._store_loaded and p2.verify() == []
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(args[0][1])
                         .astype(np.float32))
    assert torch.equal(p2.spmv(x), p.spmv(x))


def test_store_verify_counts_what_the_reference_counts(tmp_path):
    """The same flipped file read by both packages' verifying stores: the
    same hits, misses and corrupt counts (the files are one format)."""
    import repro.core.plan_store as RS

    args = _coo_args()
    store = PlanStore(str(tmp_path))
    repro_torch.plan(COOMatrix(*args), l=L, cache=None, store=store, device="cpu").artifact
    key = store.keys()[0]
    _flip_and_put(store, key)
    port, ref = PlanStore(str(tmp_path), verify="load"), RS.PlanStore(str(tmp_path),
                                                                      verify="load")
    assert port.get(key) is None and ref.get(key) is None
    assert port.stats() == ref.stats()


def test_a_verifier_crash_is_not_counted_corrupt(tmp_path, monkeypatch):
    args = _coo_args()
    store = PlanStore(str(tmp_path))
    repro_torch.plan(COOMatrix(*args), l=L, cache=None, store=store, device="cpu").artifact

    def crash(*a, **k):
        raise RuntimeError("verifier bug")

    monkeypatch.setattr(port_verify_module, "verify", crash)
    checking = PlanStore(str(tmp_path), verify="load")
    assert checking.get(store.keys()[0]) is not None
    assert checking.corrupt == 0 and checking.hits == 1


def test_serving_store_verify_passes_through(tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.core.packing import clear_cache
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving import GustServeConfig, gustify

    cfg = get_arch("yi_6b").reduced()
    lm = build_model(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    gcfg = GustServeConfig(density=0.5, gust_length=16, plan_store=str(tmp_path),
                           store_verify="load")
    cold = gustify(lm, params, gcfg)
    assert cold["stats"]["plan_store"]["writes"] == 3 * lm.stack.reps
    clear_cache()
    warm = gustify(lm, params, gcfg)
    assert warm["stats"]["plan_store"]["hits"] == 3 * lm.stack.reps
    assert warm["stats"]["plan_store"]["corrupt"] == 0
    key = PlanStore(str(tmp_path)).keys()[0]
    _flip_and_put(PlanStore(str(tmp_path)), key, "GUST-P15")
    clear_cache()
    again = gustify(lm, params, gcfg)  # the corrupt layer is packed fresh
    st = again["stats"]["plan_store"]
    assert st["corrupt"] == 1 and st["hits"] == 3 * lm.stack.reps - 1
    for name, entry in cold["mats"].items():
        assert all(torch.equal(entry["leaves"][k], again["mats"][name]["leaves"][k])
                   for k in entry["leaves"])


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, cwd=ROOT)


def test_cli_verify_store(tmp_path):
    store = PlanStore(str(tmp_path / "store"))
    for layout in ("padded", "ragged"):
        repro_torch.plan(COOMatrix(*_coo_args()), l=L, layout=layout, cache=None,
                         store=store, device="cpu").artifact
    out = _cli("verify", str(tmp_path / "store"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2 artifact(s), 0 failing" in out.stdout
    _flip_and_put(store, store.keys()[0])
    out = _cli("verify", str(tmp_path / "store"))
    assert out.returncode == 1 and "2 artifact(s), 1 failing" in out.stdout
    assert "GUST-P03" in out.stdout
    assert _cli("verify", str(tmp_path / "empty")).stdout.startswith("no artifacts")
