"""Rank programs of the port's multi-process CPU tests (gloo backend).

Run by ``tests/test_torch_distributed*.py`` as one process per rank:

    python tests/torch_dist_ranks.py <program> <rank> <world> <dir>

Each rank joins a gloo process group through the file ``<dir>/rdv`` (a
60 s timeout on every collective), runs ``<program>`` on inputs drawn from
numpy seeds, and saves what it computed to ``<dir>/<program>.<rank>.pt``.
Imports neither ``jax`` nor ``repro``.  :func:`run_ranks` starts the
processes from a test, each with its own timeout.
"""

import datetime
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GROUP_TIMEOUT_S = 60


def run_ranks(program: str, world: int, tmp_dir, timeout: float = 120.0):
    """Run ``program`` on ``world`` ranks; return each rank's saved dict.
    A rank that fails or outlives ``timeout`` fails the caller (the rest
    are killed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen([sys.executable, __file__, program, str(r), str(world),
                               str(tmp_dir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode]
    if bad:
        raise AssertionError(f"{program}: ranks failed: {bad}")
    return [torch.load(os.path.join(str(tmp_dir), f"{program}.{r}.pt"))
            for r in range(world)]


# -- inputs shared with the tests ----------------------------------------------


def sparse_dense(seed: int, m: int, n: int, density: float) -> np.ndarray:
    """A seeded sparse matrix with a heavy row (uneven windows)."""
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    d[rng.integers(0, m)] = rng.standard_normal(n).astype(np.float32)
    return d


#: Sharded SpMV cases: (seed, m, n, density, l, PlanConfig overrides).
SPMV_CASES = (
    (0, 300, 200, 0.08, 16, {}),
    (1, 300, 200, 0.08, 16, {"load_balance": False, "gather": "local"}),
    (2, 260, 700, 0.05, 16, {"value_dtype": "int8"}),
    (3, 40, 90, 0.2, 16, {"load_balance": False}),  # 3 windows: a rank owns none
)


def collective_inputs(world: int):
    """Per-rank x (37, 5) and residual-free gradients (64,), seeded."""
    rng = np.random.default_rng(7)
    return (rng.standard_normal((world, 37, 5)).astype(np.float32),
            rng.standard_normal((world, 64)).astype(np.float32))


# -- rank programs -------------------------------------------------------------


def _collectives(rank, world, mesh, tmp_dir):
    from repro_torch.distributed.collectives import compressed_psum, ring_all_reduce

    xs, gs = collective_inputs(world)
    group = mesh.get_group("data")
    ring = ring_all_reduce(torch.from_numpy(xs[rank]), group)
    g = torch.from_numpy(gs[rank])
    red, res = compressed_psum(g, torch.zeros_like(g), group)
    return {"ring": ring, "psum": red, "residual": res}


def _spmv(rank, world, mesh, tmp_dir):
    from repro_torch.core.packing import ScheduleCache
    from repro_torch.core.plan import PlanConfig, plan
    from repro_torch.core.spmv import distributed_spmv

    out = {}
    for i, (seed, m, n, dens, l, kw) in enumerate(SPMV_CASES):
        dense = sparse_dense(seed, m, n, dens)
        v = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal(n)
                             .astype(np.float32))
        cache = ScheduleCache()
        p = plan(dense, PlanConfig(l=l, c_blk=4, layout="ragged", **kw), cache=cache,
                 device="cpu")
        sharded = p.shard(mesh)
        out[f"case{i}/sharded"] = sharded.spmv(v)
        out[f"case{i}/again"] = sharded.spmv(v)  # the layout from the cache's memo
        out[f"case{i}/whole"] = p.spmv(v)
        refusals = []
        for call in (lambda: sharded.spmm(v[:, None]), lambda: sharded.spgemm(dense),
                     lambda: sharded.tune(v)):
            try:
                call()
            except NotImplementedError as e:
                refusals.append(str(e))
        out[f"case{i}/refusals"] = refusals
    # the legacy shim, from a schedule, at c_blk 1
    from repro_torch.core.scheduler import schedule
    from repro_torch.core.formats import coo_from_dense

    dense = sparse_dense(0, 300, 200, 0.08)
    v = torch.from_numpy(np.random.default_rng(100).standard_normal(200).astype(np.float32))
    out["shim"] = distributed_spmv(schedule(coo_from_dense(dense), 8), v, mesh, "data",
                                   cache=None, device="cpu")
    return out


def _train(rank, world, mesh, tmp_dir):
    from train_dp_case import dp_case

    return dp_case(mesh, tmp_dir)


def _tp(rank, world, mesh, tmp_dir):
    from train_tp_case import tp_case

    return tp_case(rank, world, tmp_dir)


def _tp_checkpoint(rank, world, mesh, tmp_dir):
    from train_tp_case import checkpoint_case

    return checkpoint_case(rank, world, tmp_dir)


def _serve(rank, world, mesh, tmp_dir):
    from serve_tp_case import serve_case

    return serve_case(rank, world, tmp_dir)


PROGRAMS = {"collectives": _collectives, "spmv": _spmv, "train": _train, "tp": _tp,
            "tp_checkpoint": _tp_checkpoint, "serve": _serve}


def main(program: str, rank: int, world: int, tmp_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_dir}/rdv", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        out = PROGRAMS[program](rank, world, mesh, tmp_dir)
        torch.save(out, os.path.join(tmp_dir, f"{program}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
