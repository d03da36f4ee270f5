"""The sharded train step's cases for the CPU tests (``tests/
test_torch_distributed_tp*.py``), run by the rank programs
(``torch_dist_ranks.py``, program ``tp``) from the states and batches a
test wrote to ``<dir>/tp_cases.pt`` (:func:`write_cases`).

Each case names an arch (reduced), a ``("data", "model")`` mesh shape,
a train config and a number of steps.  Every rank of a world the mesh
fills:

* cuts its shards (``shard_train_state``) and records their shapes
  beside ``local_shape``, its parameter and optimizer bytes beside
  ``tree_bytes_per_device``, and whether ``gather_train_state`` gives the
  whole state back bit for bit;
* runs the sharded steps under ``chip_smoke.allocations()``, which
  records the shape of every tensor an op allocates, so that the test can
  hold that no rank of a mesh larger than (1, 1) made a whole stacked
  leaf (``chip_smoke.whole_stacked_shapes``: the stacked leaves the mesh
  splits, less the shapes some local leaf also has);
* runs the whole state's step on the same mesh (PR 28's data-parallel
  step: an MoE arch routes per DP rank in both);
* saves the losses, the gradient norms and (rank 0) the gathered
  parameters after each step.

Imports neither ``jax`` nor ``repro``."""

import math
import os

import numpy as np
import torch

BATCH, SEQ = 8, 32
LR = 1e-3
AXES = ("pod", "data", "model")  # a 2-D mesh takes the last two


def tp_batch(cfg, seed: int = 3):
    """Tokens, labels, a ``loss_mask`` whose density grows down the rows
    (numpy, seeded) and, for an encoder-decoder arch, source frames."""
    rng = np.random.default_rng(seed)
    mask = rng.random((BATCH, SEQ)) < np.linspace(0.2, 1.0, BATCH)[:, None]
    out = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
           "loss_mask": mask.astype(np.float32)}
    if cfg.is_encdec:
        out["src_frames"] = rng.standard_normal((BATCH, 8, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def train_config(microbatches: int = 1, compression: bool = False):
    from repro_torch.training import AdamWConfig, TrainConfig
    from repro_torch.training.compression import CompressionConfig

    return TrainConfig(opt=AdamWConfig(lr=LR), dtype="float32", microbatches=microbatches,
                       compression=CompressionConfig(enable=compression))


def lm_of(arch: str):
    from repro_torch.configs import get_arch
    from repro_torch.models.model_zoo import build_model

    return build_model(get_arch(arch).reduced())


def write_cases(tmp_dir, cases) -> None:
    """``cases``: name -> {"arch", "mesh" ((pod,) data, model), "state" (whole),
    "microbatches", "compression", "steps"}; the batch is
    :func:`tp_batch`'s."""
    out = {}
    for name, c in cases.items():
        out[name] = dict(c, batch=tp_batch(lm_of(c["arch"]).cfg))
    torch.save(out, os.path.join(str(tmp_dir), "tp_cases.pt"))


def compress_over_shards(sharded, mesh) -> bool:
    """Whether ``compress_grads`` on every rank's shards of a seeded
    gradient and residual tree (each leaf scaled by the whole leaf's
    largest magnitude, ``over_shards`` with a max) gathers to
    ``compress_grads`` of the whole trees, bit for bit."""
    import functools

    import torch.distributed as dist

    from repro_torch.distributed.tensor_parallel import (gather_tree, mesh_axes,
                                                         over_shards, shard_tree)
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.training.compression import CompressionConfig, compress_grads

    rng = np.random.default_rng(11)
    axes, specs = mesh_axes(mesh), sharded.specs
    like = gather_tree(sharded["params"], specs, axes)
    grads = tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)), like)
    res = tree_map(lambda p: torch.from_numpy(
        (1e-2 * rng.standard_normal(tuple(p.shape))).astype(np.float32)), like)
    flat = []
    tree_map(lambda _, s: flat.append(s), like, specs)
    whole = functools.partial(over_shards, leaf_specs=flat, axes=axes, op=dist.ReduceOp.MAX)
    cfg = CompressionConfig(enable=True)
    deq, new = compress_grads(shard_tree(grads, specs, axes), shard_tree(res, specs, axes),
                              cfg, whole)
    want = compress_grads(grads, res, cfg)
    got = (gather_tree(deq, specs, axes), gather_tree(new, specs, axes))
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


def tp_case(rank: int, world: int, tmp_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from chip_smoke import allocations, whole_stacked_shapes
    from repro_torch.distributed.sharding import local_shape, tree_bytes_per_device
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.training import make_train_step
    from repro_torch.training.train_loop import gather_train_state, shard_train_state

    cases = torch.load(os.path.join(str(tmp_dir), "tp_cases.pt"))
    meshes, out = {}, {}
    for name, c in cases.items():
        shape = tuple(c["mesh"])
        if math.prod(shape) != world:
            continue
        if shape not in meshes:  # every rank makes the meshes in the same order
            meshes[shape] = init_device_mesh("cpu", shape,
                                             mesh_dim_names=AXES[-len(shape):])
        mesh = meshes[shape]
        lm, tc = lm_of(c["arch"]), train_config(c["microbatches"], c["compression"])
        whole = c["state"]
        sharded = shard_train_state(whole, mesh)
        rec = {"steps": []}
        shapes = []
        tree_map(lambda loc, w, s: shapes.append(
            (tuple(loc.shape), local_shape(tuple(w.shape), s, mesh))),
            sharded["params"], whole["params"], sharded.specs)
        rec["shapes"] = shapes
        rec["bytes"] = sum(x.numel() * x.element_size()
                           for part in (sharded["params"], sharded["opt"]["m"], sharded["opt"]["v"])
                           for x in tree_leaves(part))
        rec["bytes_reckoned"] = 3 * tree_bytes_per_device(whole["params"], sharded.specs, mesh)
        back = gather_train_state(sharded)
        rec["round_trip"] = all(torch.equal(a, b) for a, b in
                                zip(tree_leaves(back), tree_leaves(whole)))
        whole_stacks = whole_stacked_shapes(whole["params"], sharded.specs, mesh,
                                            {tuple(x.shape) for x in tree_leaves(sharded)})
        step = make_train_step(lm, tc, mesh)
        state = sharded
        watch = allocations()
        for _ in range(c["steps"]):
            with watch:
                state, metrics = step(state, c["batch"])
            row = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}
            gathered = gather_train_state(state)
            if rank == 0:
                row["state"] = gathered
            rec["steps"].append(row)
        if c["compression"]:
            rec["compress_equals_whole"] = compress_over_shards(sharded, mesh)
        rec["whole_stacks"] = sorted(whole_stacks)
        rec["whole_stacks_made"] = sorted(whole_stacks & watch.seen)
        state = whole
        rec["dp"] = []
        for _ in range(c["steps"]):
            state, metrics = step(state, c["batch"])
            rec["dp"].append({"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                              "state": state if rank == 0 else None})
        out[name] = rec
        dist.barrier()
    return out


def checkpoint_case(rank: int, world: int, tmp_dir):
    """Sharded checkpoints on a (2, 2) mesh, from ``<dir>/ckpt_case.pt``
    (``{"arch", "state", "ref_dir", "ref_step"}``: the reference's state
    carried across, and the directory where the reference's own
    ``save_checkpoint`` wrote it): the state restored from the
    reference's checkpoint into shards, bitwise the shards cut in memory;
    two steps from each, bitwise; a sharded save after the first step
    restored bitwise and the second step from it bitwise the
    uninterrupted run's."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.tree import tree_leaves
    from repro_torch.training import make_train_step
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.training.train_loop import gather_train_state, shard_train_state

    case = torch.load(os.path.join(str(tmp_dir), "ckpt_case.pt"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    lm, tc = lm_of(case["arch"]), train_config(2)
    batch = tp_batch(lm.cfg)
    step = make_train_step(lm, tc, mesh)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    cut = shard_train_state(case["state"], mesh)
    restored, _ = restore_checkpoint(case["ref_dir"], case["ref_step"], cut, device="cpu")
    out = {"restored_equals_cut": same(restored, cut),
           "restored_is_sharded": type(restored).__name__}
    one, _ = step(cut, batch)
    two, _ = step(one, batch)
    r_one, _ = step(restored, batch)
    r_two, _ = step(r_one, batch)
    out["resumed_equals_uninterrupted"] = same(r_two, two)
    port_dir = os.path.join(str(tmp_dir), "port_ckpt")
    save_checkpoint(port_dir, 1, one, extra={"note": "sharded"})
    back, extra = restore_checkpoint(port_dir, 1, cut, device="cpu")
    out["round_trip"] = same(back, one) and extra == {"note": "sharded"}
    again, _ = step(back, batch)
    out["continued_equals_uninterrupted"] = same(again, two)
    whole, saved = gather_train_state(two), gather_train_state(one)
    if rank == 0:
        out.update(whole=whole, saved=saved, port_dir=port_dir)
    return out


# -- shared by the test files ---------------------------------------------------

TOL_LOSS = 1e-5  # relative
TOL_PARAMS = 1e-6  # absolute, every element


def seeded_state(arch: str, compression: bool = False):
    """A reduced arch's train state from ``torch.Generator`` seed 0 (CPU)."""
    from repro_torch.training import init_train_state

    return init_train_state(lm_of(arch), torch.Generator().manual_seed(0),
                            train_config(2, compression), device="cpu")


def run_cases(tmp_dir, cases, world: int, timeout: float = 240.0):
    """:func:`write_cases` then program ``tp`` on ``world`` ranks: case
    name -> {rank: record}."""
    from torch_dist_ranks import run_ranks

    write_cases(tmp_dir, cases)
    out = {}
    for rank, recs in enumerate(run_ranks("tp", world, tmp_dir, timeout=timeout)):
        for name, rec in recs.items():
            out.setdefault(name, {})[rank] = rec
    return out


def single_steps(arch: str, state, steps: int, compression: bool = False):
    """The port's single-process steps from ``state``: per step the loss,
    ``grad_norm`` and new state."""
    from repro_torch.training import make_train_step

    lm = lm_of(arch)
    step, rows = make_train_step(lm, train_config(2, compression)), []
    for _ in range(steps):
        state, m = step(state, tp_batch(lm.cfg))
        rows.append({"loss": m["loss"], "grad_norm": m["grad_norm"], "state": state})
    return rows


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def check_steps(ranks, wants, params: bool = True) -> None:
    """Rank 0's steps against ``wants`` (loss and ``grad_norm`` within
    ``TOL_LOSS`` relative; with ``params`` every float leaf of the state
    within ``TOL_PARAMS``); every rank's metrics equal rank 0's."""
    from repro_torch.models.tree import tree_leaves

    for i, want in enumerate(wants):
        got = ranks[0]["steps"][i]
        for k in ("loss", "grad_norm"):
            assert _rel(got[k], want[k]) <= TOL_LOSS, (i, k, float(got[k]), float(want[k]))
        if params:
            worst = max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(got["state"]), tree_leaves(want["state"]))
                if a.is_floating_point())
            assert worst <= TOL_PARAMS, (i, worst)
    for rec in ranks.values():
        for a, b in zip(rec["steps"], ranks[0]["steps"]):
            assert torch.equal(a["loss"], b["loss"])
            assert torch.equal(a["grad_norm"], b["grad_norm"])


def check_shards(ranks) -> None:
    """Every rank: ``local_shape`` shards, ``tree_bytes_per_device``
    bytes, a bitwise gather, no whole stacked leaf allocated."""
    for rec in ranks.values():
        assert all(loc == want for loc, want in rec["shapes"]), rec["shapes"]
        assert rec["bytes"] == rec["bytes_reckoned"]
        assert rec["round_trip"]
        assert rec["whole_stacks"], "the check must have whole stacked shapes to watch"
        assert rec["whole_stacks_made"] == [], rec["whole_stacks_made"]
