"""The sharded serve step's cases for the CPU tests (``tests/
test_torch_distributed_serve*.py``, ``test_torch_dryrun_serve_tp.py``),
run by the rank programs (``torch_dist_ranks.py``, program ``serve``)
from the parameters and inputs a test wrote to ``<dir>/serve_cases.pt``
(:func:`write_cases`).

Each case names an arch (reduced, with optional config overrides), a
``("data", "model")`` or ``("pod", "data", "model")`` mesh shape, the
whole parameters, a prompt (and an encoder-decoder arch's source frames),
the teacher-forced decode tokens, the cache length and the dtype; a GUST
case also a ``GustServeConfig``.  Every rank of a world the mesh fills:

* makes its shards of the parameters and of fresh caches
  (``init_serve_state``) and records whether they equal the shards that
  ``shard_serve_state`` cuts from whole caches bit for bit, their shapes
  beside ``local_shape``, its parameter and cache bytes beside
  ``tree_bytes_per_device``, and whether ``gather_serve_state`` gives the
  whole trees back bit for bit;
* makes those shards and runs the sharded prefill and decode steps
  (``LM.prefill``, ``LM.decode_step`` or ``decode_step_gust`` with
  ``place=``) under ``chip_smoke.allocations()``, against the whole shapes
  of every stacked parameter leaf and every cache leaf (and layer of one)
  that the mesh splits (``chip_smoke.whole_stacked_shapes``,
  ``whole_cache_shapes``), less the shapes a block's own gathers may make
  (:func:`layer_shapes`) and the local ones;
* saves its rows' logits of each step, the bytes each collective sent in
  the last decode step, whether any output kept an autograd graph, and
  (rank 0) the caches gathered whole after the last step.

Imports neither ``jax`` nor ``repro``."""

import dataclasses
import math
import os

import numpy as np
import torch

AXES = ("pod", "data", "model")  # a 2-D mesh takes the last two


def lm_of(arch: str, overrides=None):
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model

    return build_model(dataclasses.replace(get_arch(arch).reduced(), **(overrides or {})))


def serve_inputs(cfg, batch: int, prompt: int, seed: int = 5):
    """The prompt batch (tokens, and an encoder-decoder arch's source
    frames at its ``enc_seq``), from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt)).astype(np.int32))}
    if cfg.is_encdec:
        out["src_frames"] = torch.from_numpy(
            rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return out


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def gust_of(lm, params, gust_cfg):
    from repro_torch.serving import GustServeConfig, gustify

    return gustify(lm, params, GustServeConfig(**gust_cfg))


def decode_run(lm, params, caches, batch, tokens, pos0: int, dtype, gust=None, place=None,
               on_step=None):
    """Prefill ``batch`` then decode ``tokens`` (T, B, 1) at positions
    ``pos0 + t`` (every row's, a (B,) vector); returns (logits of the
    prefill and of each step, the caches).  ``on_step(t)`` runs before
    step ``t``."""
    from repro_torch.serving import decode_step_gust

    logits, caches = lm.prefill(params, batch, caches, dtype=dtype, place=place)
    out = [logits]
    b = tokens.shape[1]
    for t in range(tokens.shape[0]):
        if on_step is not None:
            on_step(t)
        pos = torch.full((b,), pos0 + t, dtype=torch.int32)
        if gust is None:
            lg, caches = lm.decode_step(params, caches, tokens[t], pos, dtype=dtype,
                                        place=place)
        else:
            lg, caches = decode_step_gust(lm, params, gust, caches, tokens[t], pos,
                                          dtype=dtype, place=place)
        out.append(lg)
    return out, caches


def write_cases(tmp_dir, cases) -> None:
    """``cases``: name -> {"arch", "overrides", "mesh", "params" (whole),
    "batch" (``serve_inputs``'), "tokens" (T, B, 1), "seq_len", "dtype"
    (a name), "gust" (a ``GustServeConfig``'s fields, or None)}."""
    torch.save(cases, os.path.join(str(tmp_dir), "serve_cases.pt"))


def layer_shapes(params):
    """Each parameter leaf's shape in one block (a rep-stacked leaf's
    without its ``R``): what a block's gathers may make whole (the large
    serve leaves' "data" dims, a recurrent mixer's "model" dims)."""
    from repro_torch.distributed.sharding import map_with_path

    out = set()
    map_with_path(lambda path, leaf: out.add(
        tuple(leaf.shape)[1:] if "/reps/" in f"/{path}/" else tuple(leaf.shape)), params)
    return out


def serve_case(rank: int, world: int, tmp_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from chip_smoke import allocations, whole_cache_shapes, whole_stacked_shapes
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import local_shape, tree_bytes_per_device
    from repro_torch.distributed.tensor_parallel import gather_tree
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.serving import gather_serve_state, init_serve_state, shard_serve_state

    cases = torch.load(os.path.join(str(tmp_dir), "serve_cases.pt"))
    meshes, out = {}, {}
    for name, c in cases.items():
        shape = tuple(c["mesh"])
        if math.prod(shape) != world:
            continue
        if shape not in meshes:  # every rank makes the meshes in the same order
            meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=AXES[-len(shape):])
        mesh = meshes[shape]
        lm = lm_of(c["arch"], c.get("overrides"))
        dtype = torch_dtype(c["dtype"])
        b = c["tokens"].shape[1]
        caches = lm.init_caches(b, c["seq_len"], dtype, device="cpu")  # the yardstick
        gust = gust_of(lm, c["params"], c["gust"]) if c.get("gust") else None
        watch = allocations()
        with watch:
            state = init_serve_state(lm, c["params"], mesh, b, c["seq_len"], dtype)
        place = state.place
        cut = shard_serve_state(c["params"], caches, mesh)
        rec = {"rows": place.rows, "coords": {n: a.rank for n, a in place.axes.items()}}
        rec["fresh_equal"] = all(
            a.shape == w.shape and a.dtype == w.dtype and torch.equal(a, w)
            for a, w in zip(tree_leaves((state.params, state.caches)),
                            tree_leaves((cut.params, cut.caches))))
        shapes = []
        for shard, whole, specs in ((state.params, c["params"], place.specs),
                                    (state.caches, caches, place.cache)):
            tree_map(lambda loc, w, s: shapes.append(
                (tuple(loc.shape), local_shape(tuple(w.shape), s, mesh))), shard, whole, specs)
        rec["shapes"] = shapes
        rec["bytes"] = sum(x.numel() * x.element_size()
                           for x in tree_leaves(state.params) + tree_leaves(state.caches))
        rec["bytes_reckoned"] = (tree_bytes_per_device(c["params"], place.specs, mesh)
                                 + tree_bytes_per_device(caches, place.cache, mesh))
        back = gather_serve_state(state)
        rec["round_trip"] = all(torch.equal(a, w) for a, w in zip(
            tree_leaves(back), tree_leaves((c["params"], caches))))
        local = {tuple(x.shape) for x in tree_leaves((state.params, state.caches))}
        local |= layer_shapes(c["params"])
        watched = (whole_stacked_shapes(c["params"], place.specs, mesh, local)
                   | whole_cache_shapes(caches, place.cache, mesh, local))
        steps = c["tokens"].shape[0]

        def on_step(t):
            if t == steps - 1:  # the last step's traffic alone
                collectives.reset_traffic()

        with watch:
            logits, new = decode_run(lm, state.params, state.caches, c["batch"], c["tokens"],
                                     c["batch"]["tokens"].shape[1], dtype, gust, place,
                                     on_step)
        rec["traffic"] = {op: dict(row) for op, row in collectives.traffic.items()}
        collectives.reset_traffic()
        rec["logits"] = logits
        rec["grad"] = any(t.requires_grad or t.grad_fn is not None
                          for t in logits + tree_leaves(new))
        rec["watched"] = sorted(watched)
        rec["whole_made"] = sorted(watched & watch.seen)
        gathered = gather_tree(new, place.cache, place.axes)
        if rank == 0:
            rec["caches"] = gathered
        out[name] = rec
        dist.barrier()
    return out


# -- shared by the test files ---------------------------------------------------

TOL = 1e-5  # of the largest |logit|, float32
TOL_BF16 = 2e-2  # of the largest |logit|, bfloat16


def run_cases(tmp_dir, cases, world: int, timeout: float = 240.0):
    """:func:`write_cases` then program ``serve`` on ``world`` ranks: case
    name -> {rank: record}."""
    from torch_dist_ranks import run_ranks

    write_cases(tmp_dir, cases)
    out = {}
    for rank, recs in enumerate(run_ranks("serve", world, tmp_dir, timeout=timeout)):
        for name, rec in recs.items():
            out.setdefault(name, {})[rank] = rec
    return out


def rows_of(rec, b: int):
    """(first, count) of a rank's rows."""
    return (0, b) if rec["rows"] is None else tuple(rec["rows"])


def whole_runs(case):
    """The port's whole decode of each rank's rows (the yardstick): rows
    ``(first, count)`` -> (logits per step, caches).  A data rank's rows run
    on their own, as its MoE routes them."""
    lm = lm_of(case["arch"], case.get("overrides"))
    dtype = torch_dtype(case["dtype"])
    b = case["tokens"].shape[1]
    dp = math.prod(case["mesh"][:-1])
    n = b // dp if b % dp == 0 else b
    gust = gust_of(lm, case["params"], case["gust"]) if case.get("gust") else None
    out = {}
    for first in range(0, b, n):
        batch = {k: v[first:first + n] for k, v in case["batch"].items()}
        caches = lm.init_caches(n, case["seq_len"], dtype, device="cpu")
        out[(first, n)] = decode_run(lm, case["params"], caches, batch,
                                     case["tokens"][:, first:first + n],
                                     case["batch"]["tokens"].shape[1], dtype, gust)
    return out


def greedy_tokens(lm, params, batch, seq_len: int, steps: int, dtype, gust_cfg=None):
    """The whole decode's greedy tokens (steps, B, 1): what the ranks are
    teacher-forced on."""
    from repro_torch.serving import decode_step_gust

    b = batch["tokens"].shape[0]
    gust = gust_of(lm, params, gust_cfg) if gust_cfg else None
    caches = lm.init_caches(b, seq_len, dtype, device="cpu")
    logits, caches = lm.prefill(params, batch, caches, dtype=dtype)
    toks, pos = [], batch["tokens"].shape[1]
    for t in range(steps):
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        if gust is None:
            logits, caches = lm.decode_step(params, caches, tok, pos + t, dtype=dtype)
        else:
            logits, caches = decode_step_gust(lm, params, gust, caches, tok, pos + t,
                                              dtype=dtype)
    return torch.stack(toks)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


def check_logits(ranks, wants, b: int, tol: float) -> None:
    """Every rank's logits of the prefill and each step within ``tol`` of
    the largest |logit| of the whole decode of its rows (of ``b``)."""
    for r, rec in ranks.items():
        want = wants[rows_of(rec, b)][0]
        assert len(rec["logits"]) == len(want)
        for t, (g, w) in enumerate(zip(rec["logits"], want)):
            assert g.shape == w.shape, (r, t, g.shape, w.shape)
            assert rel_err(g, w) <= tol, (r, t, rel_err(g, w))


def check_shards(ranks) -> None:
    """Every rank: fresh shards equal to those cut from whole caches,
    ``local_shape`` shards, ``tree_bytes_per_device`` bytes, a bitwise
    round trip, no whole split leaf allocated, no autograd graph kept."""
    for rec in ranks.values():
        assert rec["fresh_equal"]
        assert all(loc == want for loc, want in rec["shapes"]), rec["shapes"]
        assert rec["bytes"] == rec["bytes_reckoned"]
        assert rec["round_trip"]
        assert rec["watched"], "the check must have whole shapes to watch"
        assert rec["whole_made"] == [], rec["whole_made"]
        assert not rec["grad"]
