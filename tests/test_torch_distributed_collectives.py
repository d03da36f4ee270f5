"""Port parity of the collectives (``repro_torch.distributed.collectives``)
and of the sharded SpMV's values, against the reference on XLA devices.

* Over 4 gloo ranks (one process each), ``ring_all_reduce`` equals the
  reference's ``ring_all_reduce`` (``ppermute`` hops inside ``shard_map``
  over 4 devices) bitwise on every rank: the same chunks, padding and
  hop order.  ``compressed_psum``'s residual equals the reference's
  bitwise; its sum agrees within ``1e-6 · max|sum|`` (gloo's and XLA's
  all-reduce add the ranks in their own orders).  The reference's
  ``compressed_psum`` runs under ``jax.disable_jit``: jitted, XLA turns
  its division by ``qmax`` into a multiply by the reciprocal, which moves
  the scale by an ulp.
* ``bucketed`` / ``unbucketed`` round-trip bitwise, dtypes kept.
* The port's sharded ``spmv`` (equal bitwise to its unsharded ``spmv``:
  ``tests/test_torch_distributed.py``) is within ``1e-5·(|M|·|x|)`` per
  row of the reference's sharded ``spmv`` on 8 XLA devices, on the float
  cases (the reference's shard path reads int8 values without their
  per-block scales, so it is not a yardstick for int8).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core.plan import PlanConfig, plan
from repro_torch.distributed.collectives import bucketed, unbucketed

from conftest import run_spmd_subprocess
from torch_dist_ranks import SPMV_CASES, collective_inputs, run_ranks, sparse_dense

torch.set_num_threads(1)

WORLD = 4
TOL_SPMV = 1e-5  # per row, of |M|·|x|: the reference sums by segment_sum
TOL_PSUM = 1e-6  # of the largest |sum|: the all-reduce orders differ
FLOAT_CASES = [i for i, c in enumerate(SPMV_CASES) if c[5].get("value_dtype") != "int8"]


@pytest.fixture(scope="module")
def reference():
    """The reference's collectives on 4 XLA devices and its sharded spmv
    on 8, in one 8-device subprocess."""
    code = f"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
import repro
from repro.distributed.collectives import compressed_psum, ring_all_reduce, shard_map
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
from torch_dist_ranks import SPMV_CASES, collective_inputs, sparse_dense
xs, gs = collective_inputs({WORLD})
mesh4 = Mesh(np.array(jax.devices()[:{WORLD}]), ("x",))
def f(a):
    red, res = compressed_psum(a[0], jnp.zeros_like(a[0]), "x")
    return red[None], res[None]
ring = jax.jit(shard_map(lambda a: ring_all_reduce(a[0], "x")[None], mesh=mesh4,
                         in_specs=P("x"), out_specs=P("x")))(jnp.asarray(xs))
with jax.disable_jit():
    red, res = shard_map(f, mesh=mesh4, in_specs=P("x"),
                         out_specs=(P("x"), P("x")))(jnp.asarray(gs))
mesh8 = Mesh(np.array(jax.devices()).reshape(8), ("data",))
spmv = {{}}
for i in {FLOAT_CASES!r}:
    seed, m, n, dens, l, kw = SPMV_CASES[i]
    v = np.random.default_rng(seed + 100).standard_normal(n).astype(np.float32)
    p = repro.plan(sparse_dense(seed, m, n, dens),
                   repro.PlanConfig(l=l, c_blk=4, layout="ragged", backend="jnp", **kw),
                   cache=None)
    spmv[i] = np.asarray(p.shard(mesh8).spmv(jnp.asarray(v))).tolist()
print(json.dumps({{"ring": np.asarray(ring).tolist(), "psum": np.asarray(red).tolist(),
                  "residual": np.asarray(res).tolist(), "spmv": spmv}}))
"""
    out = run_spmd_subprocess(code, devices=8, timeout=240)
    return json.loads(out.strip().splitlines()[-1])


def test_ring_and_compressed_psum_match_reference(reference, tmp_path):
    outs = run_ranks("collectives", WORLD, tmp_path)
    ring = np.asarray(reference["ring"], np.float32)
    red = np.asarray(reference["psum"], np.float32)
    res = np.asarray(reference["residual"], np.float32)
    xs, _ = collective_inputs(WORLD)
    for rank, out in enumerate(outs):
        assert np.array_equal(out["ring"].numpy(), ring[rank]), rank
        assert np.array_equal(out["residual"].numpy(), res[rank]), rank
        scale = np.abs(red[rank]).max()
        assert np.abs(out["psum"].numpy() - red[rank]).max() <= TOL_PSUM * scale, rank
    assert np.abs(ring[0] - xs.sum(0)).max() < 1e-4


def test_sharded_spmv_agrees_with_reference_on_8_devices(reference):
    for i in FLOAT_CASES:
        seed, m, n, dens, l, kw = SPMV_CASES[i]
        dense = sparse_dense(seed, m, n, dens)
        v = np.random.default_rng(seed + 100).standard_normal(n).astype(np.float32)
        got = plan(dense, PlanConfig(l=l, c_blk=4, layout="ragged", **kw), cache=None,
                   device="cpu").spmv(torch.from_numpy(v)).numpy()
        bound = TOL_SPMV * (np.abs(dense) @ np.abs(v))
        assert np.all(np.abs(got - np.asarray(reference["spmv"][str(i)], np.float32))
                      <= bound), i


def test_bucketed_round_trip_is_bitwise():
    rng = np.random.default_rng(5)
    tensors = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 4), (17,), (2, 3, 5), (1,))]
    tensors.append(tensors[0].to(torch.bfloat16))
    buckets, spec = bucketed(tensors, bucket_bytes=64)
    assert len(buckets) > 1 and all(b.dtype == torch.float32 for b in buckets)
    back = unbucketed(buckets, spec)
    for a, b in zip(tensors, back):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    one, spec1 = bucketed(tensors)
    assert len(one) == 1
    assert all(torch.equal(a, b) for a, b in zip(tensors, unbucketed(one, spec1)))
