"""Multi-device dry-run: the meta-device account of every (arch × shape ×
mesh) cell.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 512 placeholder XLA devices.  The port compiles nothing: for each
cell it builds the real trees on the meta device, lays them out by the
real sharding rules over a :class:`~repro_torch.distributed.sharding.MeshLayout`
of the production mesh (no process per device), and runs the real step
on meta tensors (``launch/cost_account.py``): exact bytes per device,
matmul FLOPs, peak temporaries, H100 roofline terms and whether the cell
fits.  The cell policies (``microbatches_for``, ``skip_reason``) and the
GUST decode cell are the reference's.  One JSON per cell goes to
``results/dryrun_torch/`` (never the reference's ``results/dryrun/``);
a cell already there is skipped unless ``--force``.

Usage (on the host; no card needed):
    python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch yi_6b --gust-decode
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs.base import ARCH_IDS, SHAPES, get_arch
from ..distributed.sharding import MeshLayout, dp_size
from ..models.model_zoo import build_model
from ..models.tree import tree_leaves
from .cost_account import account_cell
from .mesh import mesh_shape

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                           "results", "dryrun_torch")


def production_layout(multi_pod: bool) -> MeshLayout:
    """The production mesh's layout, (16, 16) or (2, 16, 16)."""
    return MeshLayout(*mesh_shape(multi_pod))


def microbatches_for(n_params: int, shape, mesh) -> int:
    """Gradient-accumulation depth: targets per-device microbatch rows of
    1 (>15B), 2 (>3B) or 4 (smaller).  Always >= 1 row per device."""
    dp = dp_size(mesh)
    rows = 1 if n_params > 15e9 else (2 if n_params > 3e9 else 4)
    mb = max(shape.global_batch // (dp * rows), 1)
    while shape.global_batch % (mb * dp) or (shape.global_batch // mb) % dp:
        mb -= 1
    return max(mb, 1)


def skip_reason(arch_id: str, shape_name: str) -> Optional[str]:
    cfg = get_arch(arch_id)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return "pure full attention: long_500k disqualified (DESIGN.md S5)"
    if shape_name == "long_500k" and cfg.is_encdec:
        return "enc-dec: 0.5M-frame source out of family spec (DESIGN.md S5)"
    return None


def build_cell(arch_id: str, shape_name: str, mesh) -> Dict:
    """The account of one cell: train cells in f32 parameters with a bf16
    step (remat, ``microbatches_for``), serving cells in bf16 parameters
    and caches."""
    lm = build_model(get_arch(arch_id))
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        n_params = sum(x.numel() for x in tree_leaves(lm.init(None)))
        return account_cell(lm, "train", shape.global_batch, shape.seq_len, mesh,
                            param_dtype=torch.float32,
                            microbatches=microbatches_for(n_params, shape, mesh))
    return account_cell(lm, shape.kind, shape.global_batch, shape.seq_len, mesh,
                        param_dtype=torch.bfloat16)


def build_gust_decode_cell(arch_id: str, mesh, density: float = 0.1,
                           gust_length: int = 256) -> Dict:
    """The GUST-sparse decode cell at ``decode_32k``: the stream of each
    MLP matrix sized from the paper's Eq. 9 bound (``serving.dryrun_specs``),
    replicated on every device.  ``REPRO_GUST_COMPACT`` / ``REPRO_GUST_RAGGED``
    select the plan's dtype policy and layout, as in the reference."""
    from ..serving.gust_serve import GustServeConfig, dryrun_specs

    lm = build_model(get_arch(arch_id))
    shape = SHAPES["decode_32k"]
    gcfg = GustServeConfig(density=density, gust_length=gust_length,
                           compact=os.environ.get("REPRO_GUST_COMPACT", "0") == "1",
                           ragged=os.environ.get("REPRO_GUST_RAGGED", "0") == "1")
    pc = gcfg.plan_config
    rec = account_cell(lm, "decode", shape.global_batch, shape.seq_len, mesh,
                       param_dtype=torch.bfloat16, gust_specs=dryrun_specs(lm, gcfg))
    rec.update(gust_density=density, gust_layout=pc.layout,
               gust_dtypes=(pc.value_dtype, pc.index_dtype), gust_gather=pc.gather)
    return rec


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, gust: bool = False) -> Dict:
    mesh_name = "multi" if multi_pod else "single"
    t0 = time.time()
    rec: Dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "gust": gust,
                 "ok": False}
    reason = skip_reason(arch_id, shape_name)
    if reason:
        rec.update(skipped=True, reason=reason, ok=True)
        return rec
    try:
        mesh = production_layout(multi_pod)
        rec.update(build_gust_decode_cell(arch_id, mesh) if gust
                   else build_cell(arch_id, shape_name, mesh))
        rec["ok"] = True
    except Exception as e:  # record the failure, don't stop the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=10)
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def cell_path(arch_id: str, shape_name: str, mesh_name: str, gust=False) -> str:
    tag = f"{arch_id}__{shape_name}__{mesh_name}" + ("__gust" if gust else "")
    return os.path.join(RESULTS_DIR, tag + ".json")


def _write(path: str, rec: Dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--gust-decode", action="store_true",
                    help="run the GUST-sparse decode cell")
    ap.add_argument("--force", action="store_true", help="ignore cached cells")
    args = ap.parse_args(argv)

    os.makedirs(RESULTS_DIR, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    n_fail = 0
    for mesh_name in meshes:
        for arch in archs:
            cells = [("decode_32k", True)] if args.gust_decode else [(s, False) for s in shapes]
            for shape, gust in cells:
                path = cell_path(arch, shape, mesh_name, gust=gust)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            continue
                rec = run_cell(arch, shape, mesh_name == "multi", gust=gust)
                _write(path, rec)
                if rec.get("skipped"):
                    print(f"[SKIP] {arch} {shape} {mesh_name}: {rec['reason']}")
                    continue
                if rec["ok"]:
                    extra = (f" peak={rec['peak_bytes'] / 2**30:.1f}GiB fits={rec['fits']} "
                             f"dom={rec['roofline']['dominant']}")
                else:
                    extra = " " + rec["error"][:120]
                    n_fail += 1
                status = "OK" if rec["ok"] else "FAIL"
                tag = "gust-decode" if gust else shape
                print(f"[{status}] {arch} {tag} {mesh_name} ({rec['wall_s']}s){extra}")
    print("dry-run failures:", n_fail)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
