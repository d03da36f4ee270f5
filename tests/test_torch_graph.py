"""Port parity of the graph analytics on the CPU.

``repro_torch.graph`` against ``repro.graph`` on the graphs of
``tests/test_graph.py`` and on the synthetic suite at n <= 64, same
``PlanConfig(l=8)``:

* ``triangle_count``: ``triangles``, ``per_node`` and ``spgemm_nnz`` equal
  (the product is exact on 0/1 patterns);
* ``pagerank``: scores within ``atol=1e-6``, the same ``converged``;
* ``feature_propagation``: within ``rtol=1e-5, atol=1e-6``.

The port runs with ``device="cpu"`` (the kernels' plain versions); the
card runs the same functions in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import repro.graph as rg
from repro.core.formats import COOMatrix as RefCOO
from repro.core.plan import PlanConfig as RefConfig
from repro.data import matrices as rmat

import repro_torch.graph as tg
from repro_torch.core.formats import COOMatrix as PortCOO
from repro_torch.core.plan import PlanConfig as PortConfig

torch.set_num_threads(1)  # the suite runs several test processes at once

REF_CFG, PORT_CFG = RefConfig(l=8), PortConfig(l=8)


def _ring(n):
    rows = np.arange(n, dtype=np.int64)
    return RefCOO((n, n), rows, (rows + 1) % n, np.ones(n, np.float32))


def _graphs():
    rng = np.random.default_rng(0)
    k4 = np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32)
    pendant = np.zeros((4, 4), np.float32)
    for i, j in [(0, 1), (1, 2), (2, 0), (2, 3)]:
        pendant[i, j] = pendant[j, i] = 1.0
    dangling = np.zeros((4, 4), np.float32)
    dangling[0, 1] = dangling[1, 2] = dangling[3, 0] = 1.0
    weighted = (rng.random((20, 20)) < 0.25).astype(np.float32) * 7.0 + np.eye(
        20, dtype=np.float32)
    return {
        "ring12": _ring(12),
        "k4": k4,
        "pendant": pendant,
        "dangling": dangling,
        "random24": (rng.random((24, 24)) < 0.15).astype(np.float32),
        "weighted20": weighted,
        "uniform64": rmat.synth_uniform(64, 0.08, seed=1),
        "power_law48": rmat.synth_power_law(48, 0.06, seed=9),
        "power_law64": rmat.synth_power_law(64, 0.05, seed=2),
        "k_regular64": rmat.synth_k_regular(64, 0.06, seed=3),
        "banded64": rmat.synth_banded(64, 300, seed=4),
        "block64": rmat.synth_block_diagonal(64, 300, num_blocks=4, seed=5),
    }


GRAPHS = _graphs()


def _port(adj):
    if isinstance(adj, RefCOO):
        return PortCOO(adj.shape, adj.rows, adj.cols, adj.vals)
    return adj


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_triangle_count_matches_reference(name):
    adj = GRAPHS[name]
    want = rg.triangle_count(adj, config=REF_CFG)
    got = tg.triangle_count(_port(adj), config=PORT_CFG, device="cpu")
    assert got.triangles == want.triangles
    assert np.array_equal(got.per_node, want.per_node)
    assert got.spgemm_nnz == want.spgemm_nnz
    assert got.clustering_coefficient == want.clustering_coefficient


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pagerank_matches_reference(name):
    adj = GRAPHS[name]
    for kw in ({}, {"damping": 0.5, "tol": 1e-7}):
        want = rg.pagerank(adj, config=REF_CFG, **kw)
        got = tg.pagerank(_port(adj), config=PORT_CFG, device="cpu", **kw)
        assert got.converged == want.converged
        assert got.scores.dtype == np.float32 and got.scores.shape == want.scores.shape
        np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-6)
        assert np.array_equal(got.top(3), np.argsort(-got.scores)[:3])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_feature_propagation_matches_reference(name):
    adj = GRAPHS[name]
    n = adj.shape[0]
    feats = np.random.default_rng(7).standard_normal((n, 5)).astype(np.float32)
    for layers, loops in ((2, True), (1, False), (0, True)):
        want = rg.feature_propagation(adj, feats, num_layers=layers,
                                      add_self_loops=loops, config=REF_CFG)
        got = tg.feature_propagation(_port(adj), feats, num_layers=layers,
                                     add_self_loops=loops, config=PORT_CFG, device="cpu")
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_validation_matches_reference():
    adj = np.zeros((6, 6), np.float32)
    adj[0, 1] = 1.0
    for mod, kw in ((rg, {}), (tg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="features"):
            mod.feature_propagation(adj, np.zeros((3, 2), np.float32), **kw)
        with pytest.raises(ValueError, match="square"):
            mod.pagerank(np.zeros((2, 3), np.float32), **kw)
        with pytest.raises(ValueError, match="2-D"):
            mod.triangle_count(np.zeros(4, np.float32), **kw)
    empty = tg.triangle_count(np.zeros((5, 5), np.float32), device="cpu")
    assert empty.triangles == 0 and empty.spgemm_nnz == 0
    assert tg.pagerank(np.zeros((0, 0), np.float32), device="cpu").converged
