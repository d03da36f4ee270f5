"""Sharded serving (``shard_serve_state`` + ``LM.prefill`` /
``LM.decode_step`` / ``decode_step_gust`` with ``place=``):
``param_specs(..., mode="serve")`` and ``cache_spec_overrides`` executed,
each rank holding only its shards.  The counterpart of the reference's
decode step compiled with those shardings (``tests/test_launch.py``, the
dry-run's prefill, decode and GUST decode cells).

Four gloo ranks (one process each, ``torch_dist_ranks.run_ranks``,
program ``serve``: ``serve_tp_case.py``) run the dense GQA archs from the
reference's initial parameters carried across, batch 4, a 14-token
prompt, then 4 decode steps teacher-forced on the whole decode's greedy
tokens, on ("data", "model") meshes (2, 2) and (1, 4) and the ("pod",
"data", "model") mesh (2, 2, 1):

* ``yi`` on (2, 2) and (1, 4) at a cache of 32 positions (its length
  split over "model": the flash decode); ``phi3`` on (1, 4) at 30 (the
  length whole: each rank's heads against the whole cache, its 2 KV heads
  whole under 4 model ranks); ``yi`` on (2, 2, 1) (rows over "pod" and
  "data", no model split); ``yi`` at ``d_ff`` 16,384 on (2, 2), whose MLP
  leaves reach the serve rule's 4 MiB and are gathered over "data" per
  block; ``yi`` in bfloat16 on (2, 2); the GUST decode on ``device="cpu"``
  plans on (2, 2) and (1, 4).

Per case and rank:

* the prefill's and every step's logits (the rank's rows, every column)
  within 1e-5 of the largest |logit| of the port's whole decode of the
  same rows (2% in bfloat16), and the prefill's and first step's within
  the reference's float32 tolerance (``rtol=1e-4, atol=1e-5``) of the
  reference's jitted whole decode (its ``decode_step_gust`` for GUST);
* the caches gathered back after the last step: ``pos`` bit for bit, and
  every other leaf bit for bit where the mesh has one model rank; over
  two or four model ranks K/V and the recurrent states are within 1e-5
  of the largest value, since the row-parallel sums add the heads'
  partial products in another order than the whole product (no float32
  order makes those bits equal);
* every shard has ``local_shape``'s shape, the parameter and cache bytes
  equal ``tree_bytes_per_device``'s, ``gather_serve_state`` gives the
  whole trees back bit for bit, no rank allocates a whole stacked
  parameter leaf or a whole cache leaf that the mesh splits (from the
  shards' set-up, ``init_serve_state``, through the last step), and no
  output keeps an autograd graph.

Besides, for every arch in one process (rank 0 of torch's ``fake``
process-group backend, ``cost_account.fake_mesh``): the cache shards that
``init_serve_state`` makes at their local shapes equal, bit for bit, those
``shard_serve_state`` cuts from ``LM.init_caches``' whole caches.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.serving as RS
from repro.configs.base import get_arch as ref_get_arch
from repro.models.model_zoo import build_model as ref_build
from repro.serving.gust_serve import gustify as ref_gustify

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.convert import from_reference_params
from repro_torch.distributed.sharding import MeshLayout, map_with_path
from repro_torch.launch.cost_account import fake_mesh
from repro_torch.models.tree import tree_leaves
from repro_torch.serving import init_serve_state, shard_serve_state

from test_torch_models import Jitted
from serve_tp_case import (TOL, TOL_BF16, check_logits, check_shards, greedy_tokens, lm_of,
                           rel_err, rows_of, run_cases, serve_inputs, torch_dtype, whole_runs)

torch.set_num_threads(1)

BATCH, PROMPT, STEPS = 4, 14, 4
REF_F32 = dict(rtol=1e-4, atol=1e-5)
GUST = dict(density=0.5, gust_length=16)

#: name -> (arch, config overrides, mesh, cache length, dtype, GUST config)
CASES = {
    "yi-2x2": ("yi_6b", {}, (2, 2), 32, "float32", None),
    "yi-1x4": ("yi_6b", {}, (1, 4), 32, "float32", None),
    "phi3-1x4-whole-length": ("phi3_mini_3_8b", {}, (1, 4), 30, "float32", None),
    "yi-2x2x1": ("yi_6b", {}, (2, 2, 1), 32, "float32", None),
    "yi-fsdp-2x2": ("yi_6b", {"d_ff": 16384}, (2, 2), 32, "float32", None),
    "yi-bf16-2x2": ("yi_6b", {}, (2, 2), 32, "bfloat16", None),
    "gust-2x2": ("yi_6b", {}, (2, 2), 32, "float32", GUST),
    "gust-1x4": ("yi_6b", {}, (1, 4), 32, "float32", GUST),
}


def reference_params(arch, overrides):
    """(the reference's reduced LM, its initial parameters, the same
    parameters carried across to the port's tree)."""
    rcfg = dataclasses.replace(ref_get_arch(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    rlm = ref_build(rcfg)
    rparams = jax.jit(rlm.init)(jax.random.PRNGKey(0))
    return rlm, rparams, from_reference_params(jax.tree.map(np.asarray, rparams), cfg,
                                               device="cpu")


def build_cases(cases):
    """The rank programs' cases and, per case, the reference's LM and
    parameters."""
    out, refs = {}, {}
    for name, (arch, over, mesh, seq_len, dtype, gust) in cases.items():
        rlm, rparams, params = reference_params(arch, over)
        lm = lm_of(arch, over)
        batch = serve_inputs(lm.cfg, BATCH, PROMPT)
        tokens = greedy_tokens(lm, params, batch, seq_len, STEPS, torch_dtype(dtype), gust)
        out[name] = dict(arch=arch, overrides=over, mesh=mesh, params=params, batch=batch,
                         tokens=tokens, seq_len=seq_len, dtype=dtype, gust=gust)
        refs[name] = (rlm, rparams)
    return out, refs


def reference_first_step(rlm, jitted, rparams, case, rows):
    """The reference's whole prefill and first decode step of ``rows``
    (``jitted``: ``rlm``'s jitted entry points; its ``decode_step_gust``
    for a GUST case): two logits."""
    first, n = rows
    dtype = jnp.float32 if case["dtype"] == "float32" else jnp.bfloat16
    batch = {k: jnp.asarray(v[first:first + n].numpy()) for k, v in case["batch"].items()}
    caches = rlm.init_caches(n, case["seq_len"], dtype)
    lp, caches = jitted.prefill(rparams, batch, caches, dtype=dtype)
    tok = jnp.asarray(case["tokens"][0, first:first + n].numpy())
    pos = jnp.full((n,), case["batch"]["tokens"].shape[1], jnp.int32)
    if case["gust"]:
        gcfg = RS.GustServeConfig(**case["gust"])
        gust = ref_gustify(rlm, rparams, gcfg)
        ld, _ = RS.decode_step_gust(rlm, rparams, gust, caches, tok, pos, cfg=gcfg,
                                    dtype=dtype)
    else:
        ld, _ = jitted.decode_step(rparams, caches, tok, pos, dtype=dtype)
    return np.asarray(lp, np.float32), np.asarray(ld, np.float32)


def check_reference(ranks, case, ref):
    """Every rank's prefill and first step against the reference's (one
    reference run per row slice)."""
    rlm, rparams = ref
    jitted, wants = Jitted(rlm), {}
    for rec in ranks.values():
        rows = rows_of(rec, BATCH)
        if rows not in wants:
            wants[rows] = reference_first_step(rlm, jitted, rparams, case, rows)
        for got, w in zip(rec["logits"][:2], wants[rows]):
            np.testing.assert_allclose(got.float().numpy(), w, **REF_F32)


def _cat_rows(trees):
    """Per-row-slice cache trees joined along the batch (dim 1 of a
    rep-stacked leaf, 0 of a tail leaf)."""
    flat = [[] for _ in tree_leaves(trees[0])]
    paths = []
    map_with_path(lambda path, _: paths.append(path), trees[0])
    for t in trees:
        for i, x in enumerate(tree_leaves(t)):
            flat[i].append(x)
    return paths, [torch.cat(xs, dim=1 if "/reps/" in f"/{p}/" else 0)
                   for p, xs in zip(paths, flat)]


def check_caches(ranks, wants, case) -> None:
    """Rank 0's gathered caches against the whole decodes' (joined over
    the row slices): ``pos`` bitwise; the rest bitwise at one model rank,
    else within ``TOL`` (``TOL_BF16``) of the largest value."""
    got = tree_leaves(ranks[0]["caches"])
    paths, want = _cat_rows([wants[k][1] for k in sorted(wants)])
    tp = case["mesh"][-1]
    tol = TOL if case["dtype"] == "float32" else TOL_BF16
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        if path.endswith("pos") or tp == 1:
            assert torch.equal(g, w), path
        elif w.abs().max() > 0:
            assert rel_err(g, w) <= tol, (path, rel_err(g, w))


def run_all(tmp_path_factory, cases, label):
    tmp = tmp_path_factory.mktemp(label)
    rank_cases, refs = build_cases(cases)
    outs = run_cases(tmp, rank_cases, world=4, timeout=300)
    return {"outs": outs, "cases": rank_cases, "refs": refs,
            "wants": {name: whole_runs(c) for name, c in rank_cases.items()}}


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    return run_all(tmp_path_factory, CASES, "serve_dense")


def _tol(case):
    return TOL if case["dtype"] == "float32" else TOL_BF16


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_equals_whole_decode(serve, name):
    case = serve["cases"][name]
    check_logits(serve["outs"][name], serve["wants"][name], BATCH, _tol(case))


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][4] == "float32"])
def test_sharded_decode_matches_reference(serve, name):
    check_reference(serve["outs"][name], serve["cases"][name], serve["refs"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_caches_gathered_equal_whole(serve, name):
    check_caches(serve["outs"][name], serve["wants"][name], serve["cases"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_shards(serve, name):
    check_shards(serve["outs"][name])


def test_meshes_split_what_the_cases_name(serve):
    """The cases reach the paths they are named for: the FSDP case sends
    the MLP's "data" gathers (megabytes a step), the whole-length case
    holds every position on every model rank, the (2, 2, 1) mesh sends
    nothing over a one-rank model axis."""
    outs = serve["outs"]
    fsdp = outs["yi-fsdp-2x2"][0]["traffic"]["all_gather"]["bytes"]
    plain = outs["yi-2x2"][0]["traffic"]["all_gather"]["bytes"]
    assert fsdp > 1_000_000 > plain
    local = [loc for loc, _ in outs["phi3-1x4-whole-length"][0]["shapes"]]
    assert (2, 4, 30, 2, 16) in local, local  # K/V (R, B, c, KV, dh): the length whole
    assert outs["yi-2x2x1"][0]["traffic"] == {}
    assert [rec["rows"] for rec in outs["yi-2x2x1"].values()] == [(r, 1) for r in range(4)]


@pytest.mark.parametrize("arch", list_archs())
def test_fresh_cache_shards_equal_cut_caches(arch):
    """``init_serve_state``'s caches, made shard by shard, against the
    shards of whole fresh caches, on (2, 2) and (1, 4), f32 and bf16."""
    lm = lm_of(arch)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    for shape in ((2, 2), (1, 4)):
        with fake_mesh(MeshLayout(shape, ("data", "model"))) as mesh:
            for dtype in (torch.float32, torch.bfloat16):
                fresh = init_serve_state(lm, params, mesh, BATCH, 32, dtype)
                cut = shard_serve_state(params, lm.init_caches(BATCH, 32, dtype, device="cpu"),
                                        mesh)
                got, want = tree_leaves(fresh.caches), tree_leaves(cut.caches)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
