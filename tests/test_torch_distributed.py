"""Port parity of ``GustPlan.shard`` (the paper's §5.5 "k parallel
length-l GUSTs") and ``core.spmv.distributed_spmv``.

* The host layout, ``_shard_layout``, equals the reference's leaf for
  leaf (``w_max`` and the reassembly index ``idx``; each rank's artifact
  holds the rows of the reference's device-major streams ``m_d``, ``r_d``,
  ``c_d`` and its local window ids ``lw_d``), bitwise, for ``n_dev`` in
  {1, 2, 3, 4, 8, 64}, a rank with no window included; every rank's
  artifact passes the port's verifier.
* Over gloo with 2 and 4 ranks (one process each, spawned by
  ``torch_dist_ranks.run_ranks``), the sharded ``spmv`` equals the port's
  unsharded ``spmv`` bitwise on every rank (windows own disjoint adder
  rows and keep their blocks in stream order), for resident and local
  gathers, f32 and int8, and a rank that owns no window; sharded ``spmm``
  / ``spgemm`` / ``tune`` raise ``NotImplementedError`` with the
  reference's messages.
* ``tests/test_torch_distributed_collectives.py`` holds the sharded
  result to the reference's on 8 XLA devices.
"""

import numpy as np
import pytest
import torch

from repro.core.formats import coo_from_dense as ref_coo
from repro.core.packing import pack_ragged as ref_pack_ragged
from repro.core.plan import _shard_layout as ref_shard_layout
from repro.core.scheduler import schedule as ref_schedule

from repro_torch.analysis.verify import verify
from repro_torch.core.formats import coo_from_dense as port_coo
from repro_torch.core.packing import pack_ragged as port_pack_ragged
from repro_torch.core.plan import _shard_layout, rank_artifact
from repro_torch.core.scheduler import schedule as port_schedule

from torch_dist_ranks import SPMV_CASES, run_ranks, sparse_dense

torch.set_num_threads(1)

LAYOUT_MATRICES = (  # (seed, m, n, density, l, load_balance)
    (0, 300, 200, 0.08, 16, True),
    (1, 300, 200, 0.08, 16, False),
    (3, 40, 90, 0.2, 16, False),  # 3 windows: ranks past 3 own none
)


@pytest.mark.parametrize("case", range(len(LAYOUT_MATRICES)))
def test_shard_layout_equals_reference(case):
    seed, m, n, dens, l, lb = LAYOUT_MATRICES[case]
    dense = sparse_dense(seed, m, n, dens)
    ref_art = ref_pack_ragged(ref_schedule(ref_coo(dense), l, load_balance=lb), 4)
    art = port_pack_ragged(port_schedule(port_coo(dense), l, load_balance=lb), 4,
                           device="cpu")
    for n_dev in (1, 2, 3, 4, 8, 64):
        m_d, r_d, c_d, lw_d, w_max, idx = (np.asarray(a) if not isinstance(a, int) else a
                                           for a in ref_shard_layout(ref_art, n_dev))
        lay = _shard_layout(art, n_dev)
        assert lay.w_max == w_max and lay.b_max * 4 == m_d.shape[1]
        assert np.array_equal(lay.idx.numpy(), idx)
        empty = 0
        for d in range(n_dev):
            a = rank_artifact(art, lay, d)
            if a is None:
                empty += 1
                assert lay.w_cnt[d] == 0 and not m_d[d].any()
                continue
            rows = a.num_blocks * 4
            assert np.array_equal(a.m_blk.numpy(), m_d[d, :rows])
            assert np.array_equal(a.row_blk.numpy(), r_d[d, :rows])
            assert np.array_equal(a.col_blk.numpy(), c_d[d, :rows])
            assert np.array_equal(a.block_window.numpy(), lw_d[d, :a.num_blocks])
            assert a.num_windows == lay.w_cnt[d] and a.block_starts[0] == 0
            assert verify(a) == [], (n_dev, d)
        assert empty == int((lay.w_cnt == 0).sum())
        if n_dev > art.num_windows:
            assert empty == n_dev - art.num_windows


@pytest.fixture(scope="module")
def spmv_runs(tmp_path_factory):
    """The rank program ``spmv`` over 2 and 4 gloo ranks: world -> the
    ranks' outputs."""
    return {w: run_ranks("spmv", w, tmp_path_factory.mktemp(f"spmv{w}")) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_spmv_equals_unsharded_bitwise(world, spmv_runs):
    outs = spmv_runs[world]
    want_refusals = [
        "sharded plans execute single vectors; use .spmv(v) (the §5.5 row-window "
        "split concatenates per-device outputs)",
        "spgemm on a sharded plan is not supported; call it on the unsharded plan",
        "tune a plan before sharding it",
    ]
    for i in range(len(SPMV_CASES)):
        whole = outs[0][f"case{i}/whole"]
        for rank, out in enumerate(outs):
            assert torch.equal(out[f"case{i}/sharded"], whole), (i, rank)
            assert torch.equal(out[f"case{i}/again"], whole), (i, rank)
            assert out[f"case{i}/refusals"] == want_refusals
    dense = sparse_dense(0, 300, 200, 0.08)
    v = np.random.default_rng(100).standard_normal(200).astype(np.float32)
    bound = 1e-4 * (np.abs(dense) @ np.abs(v)) + 1e-6
    for out in outs:
        assert np.all(np.abs(out["shim"].numpy() - dense @ v) <= bound)


def test_shard_refuses_a_padded_spec_plan():
    """As the reference (``src/repro/core/plan.py:752-757``): a padded
    spec-plan carries no schedule to re-pack ragged; a ragged one shards."""
    from repro_torch.core.plan import GustPlan, PlanConfig

    padded = GustPlan.spec_for(64, 48, PlanConfig(l=16, layout="padded"), colors=4.0)
    with pytest.raises(ValueError, match="cannot shard a padded spec-plan"):
        padded.shard(object())
    ragged = GustPlan.spec_for(64, 48, PlanConfig(l=16, layout="ragged"), colors=4.0)
    sharded = ragged.shard(object(), "model")
    assert sharded.axis == "model" and sharded.config.mesh_axis == "model"
    assert "sharded[model]" in repr(sharded)
