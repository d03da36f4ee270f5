"""Sparse-matrix dataset substrate (paper §4 'Dataset').

The paper evaluates on (a) synthetic 16384² matrices with uniform,
power-law and k-regular structure over densities 1e-4..5e-2, and (b) nine
SuiteSparse/SNAP matrices (Table 3).  This container is offline, so the
real-world set is reproduced as *structure-matched surrogates*: same
dimension, same nnz, and a generator matching the published structure
class (FEM banded, electronic-structure block, power-law social graph,
...).  Benchmarks label them as surrogates; the GUST cycle counts are
produced by the same scheduler the paper used, on matrices with the same
summary statistics.

Counterpart of ``repro.data.matrices``: the same generators, so the same
seed gives the same matrix in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.formats import COOMatrix

__all__ = [
    "synth_uniform",
    "synth_power_law",
    "synth_k_regular",
    "synth_banded",
    "synth_block_diagonal",
    "RealWorldSpec",
    "REAL_WORLD_SUITE",
    "make_real_world_surrogate",
]


def _dedupe(m: int, n: int, rows: np.ndarray, cols: np.ndarray, rng) -> COOMatrix:
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    key = np.unique(key)
    rows = (key // n).astype(np.int64)
    cols = (key % n).astype(np.int64)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return COOMatrix((m, n), rows, cols, vals)


def synth_uniform(n: int, density: float, seed: int = 0) -> COOMatrix:
    """Uniform Bernoulli sparsity (the §3.4 statistical-bound regime)."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    rows = rng.integers(0, n, int(nnz * 1.05) + 8)
    cols = rng.integers(0, n, int(nnz * 1.05) + 8)
    coo = _dedupe(n, n, rows, cols, rng)
    if coo.nnz > nnz:  # trim overdraw
        keep = rng.choice(coo.nnz, nnz, replace=False)
        coo = COOMatrix((n, n), coo.rows[keep], coo.cols[keep], coo.vals[keep])
    return coo


def synth_power_law(n: int, density: float, alpha: float = 2.1, seed: int = 0) -> COOMatrix:
    """Power-law degree distribution (SNAP-style social graphs): both row
    and column indices drawn from a Zipf-like law."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-alpha / 2.0)
    probs /= probs.sum()
    perm_r = rng.permutation(n)
    perm_c = rng.permutation(n)
    rows = perm_r[rng.choice(n, int(nnz * 1.3) + 8, p=probs)]
    cols = perm_c[rng.choice(n, int(nnz * 1.3) + 8, p=probs)]
    coo = _dedupe(n, n, rows, cols, rng)
    if coo.nnz > nnz:
        keep = rng.choice(coo.nnz, nnz, replace=False)
        coo = COOMatrix((n, n), coo.rows[keep], coo.cols[keep], coo.vals[keep])
    return coo


def synth_k_regular(n: int, density: float, seed: int = 0) -> COOMatrix:
    """Every row has exactly k = round(n*density) nonzeros at random
    columns (SNAP k-regular generator analogue)."""
    rng = np.random.default_rng(seed)
    k = max(int(round(n * density)), 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = np.concatenate(
        [rng.choice(n, k, replace=False) for _ in range(n)]
    ).astype(np.int64)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return COOMatrix((n, n), rows, cols, vals)


def synth_banded(n: int, nnz: int, bandwidth_frac: float = 0.02, seed: int = 0) -> COOMatrix:
    """FEM/stencil surrogate: nonzeros cluster near the diagonal."""
    rng = np.random.default_rng(seed)
    bw = max(int(n * bandwidth_frac), 4)
    rows = rng.integers(0, n, int(nnz * 1.2) + 8)
    offs = np.rint(rng.standard_normal(rows.shape[0]) * bw / 3.0).astype(np.int64)
    cols = np.clip(rows + offs, 0, n - 1)
    coo = _dedupe(n, n, rows, cols, rng)
    if coo.nnz > nnz:
        keep = rng.choice(coo.nnz, nnz, replace=False)
        coo = COOMatrix((n, n), coo.rows[keep], coo.cols[keep], coo.vals[keep])
    return coo


def synth_block_diagonal(
    n: int, nnz: int, num_blocks: int = 64, seed: int = 0
) -> COOMatrix:
    """Electronic-structure surrogate (Si41Ge41H72-like): dense-ish blocks
    on the diagonal plus background noise."""
    rng = np.random.default_rng(seed)
    bs = n // num_blocks
    in_block = int(nnz * 0.85)
    blk = rng.integers(0, num_blocks, in_block)
    rows_b = blk * bs + rng.integers(0, bs, in_block)
    cols_b = blk * bs + rng.integers(0, bs, in_block)
    rest = nnz - in_block
    rows_u = rng.integers(0, n, rest)
    cols_u = rng.integers(0, n, rest)
    return _dedupe(
        n, n, np.concatenate([rows_b, rows_u]), np.concatenate([cols_b, cols_u]), rng
    )


@dataclasses.dataclass(frozen=True)
class RealWorldSpec:
    """Table 3 row: surrogate recipe for an offline container."""

    name: str
    dim: int
    nnz: int
    generator: str  # banded | block | power_law | uniform

    @property
    def density(self) -> float:
        return self.nnz / float(self.dim) ** 2


#: Table 3 of the paper.  nnz values scaled by `scale` at generation time so
#: quick benchmarks stay fast; `--full` uses scale=1.
REAL_WORLD_SUITE: Tuple[RealWorldSpec, ...] = (
    RealWorldSpec("crankseg_2", 63_838, 14_148_858, "banded"),
    RealWorldSpec("Si41Ge41H72", 185_639, 15_011_265, "block"),
    RealWorldSpec("TSOPF_RS_b2383", 38_120, 16_171_169, "block"),
    RealWorldSpec("ML_Laplace", 377_002, 27_582_698, "banded"),
    RealWorldSpec("mouse_gene", 45_101, 28_967_291, "uniform"),
    RealWorldSpec("coPapersCiteseer", 434_102, 21_114_892, "power_law"),
    RealWorldSpec("PFlow_742", 742_793, 37_138_461, "banded"),
    RealWorldSpec("googleplus", 107_614, 13_673_453, "power_law"),
    RealWorldSpec("soc_pokec", 1_632_803, 30_622_564, "power_law"),
)


def make_real_world_surrogate(spec: RealWorldSpec, scale: float = 1.0, seed: int = 0) -> COOMatrix:
    """Generate the structure-matched surrogate, optionally scaled down
    (dim and nnz shrink together, preserving density and structure)."""
    dim = max(int(spec.dim * scale), 256)
    nnz = max(int(spec.nnz * scale * scale), 512)
    nnz = min(nnz, dim * dim // 2)
    if spec.generator == "banded":
        return synth_banded(dim, nnz, seed=seed)
    if spec.generator == "block":
        return synth_block_diagonal(dim, nnz, seed=seed)
    if spec.generator == "power_law":
        density = nnz / float(dim) ** 2
        return synth_power_law(dim, density, seed=seed)
    return synth_uniform(dim, nnz / float(dim) ** 2, seed=seed)
