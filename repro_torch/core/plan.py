"""GustPlan — the plan/execute API of the port.

Counterpart of ``repro.core.plan``: schedule a matrix once, pack it
lazily on the plan's device, and execute it against any number of
vectors.

    >>> import repro_torch
    >>> p = repro_torch.plan(matrix, repro_torch.PlanConfig(l=256))
    >>> y = p.spmv(v)     # on the card, through the CUDA kernels
    >>> Y = p.spmm(X)
    >>> C = p.spgemm(B)   # sparse x sparse, a COOMatrix

The device decides the execution path: ``device="cuda"`` (the default;
it raises when no card is present) runs the hand-written kernels,
``device="cpu"`` their plain PyTorch versions.  Execution is never
retried on another path when it fails.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple, Union

import numpy as np
import torch

from .formats import COOMatrix, GustSchedule, coo_from_dense
from .packing import (
    INDEX_DTYPES,
    VALUE_DTYPES,
    PackedSchedule,
    RaggedSchedule,
    ScheduleCache,
    default_cache,
    dtype_name,
    pack_ragged,
    pack_schedule,
    ragged_waste_ratio,
    resolve_device,
    resolve_gather,
    resolve_layout,
)
from .scheduler import schedule
from ..kernels.ops import execute_spmm

if TYPE_CHECKING:  # pragma: no cover
    from .spgemm import SpgemmCost

__all__ = ["PlanConfig", "PlanCost", "GustPlan", "plan"]

_LAYOUTS = ("padded", "ragged", "auto")
_BACKENDS = ("jnp", "pallas", "auto")
_COLORERS = ("paper", "fast", "exact")
_GATHERS = ("resident", "local", "auto")
_PIPELINES = ("single", "double", "auto")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Every knob of the schedule→pack→execute pipeline — the reference's
    fields, with its defaults.

    ``backend`` and ``interpret`` choose between the reference's Pallas
    and jnp paths; in the port the plan's device chooses, so they must be
    left at ``"auto"`` and ``None``.  ``mesh_axis`` is kept for
    :meth:`GustPlan.shard`, which comes with a later slice.  With
    ``gather="auto"`` and ``pipeline="auto"`` the reference's decision
    points run unchanged; every combination of ``layout``, ``gather`` and
    ``pipeline`` runs on the card.
    """

    l: int = 256
    colorer: str = "fast"
    load_balance: bool = True
    c_blk: int = 8
    layout: str = "auto"
    backend: str = "auto"
    gather: str = "auto"
    pipeline: str = "auto"
    waste_threshold: Optional[float] = None
    value_dtype: str = "float32"
    index_dtype: str = "int32"
    interpret: Optional[bool] = None
    mesh_axis: str = "data"

    def __post_init__(self):
        if self.l < 1:
            raise ValueError(f"l must be >= 1, got {self.l}")
        if self.c_blk < 1:
            raise ValueError(f"c_blk must be >= 1, got {self.c_blk}")
        if self.layout not in _LAYOUTS:
            raise ValueError(f"layout must be one of {_LAYOUTS}, got {self.layout!r}")
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}"
            )
        if self.colorer not in _COLORERS:
            raise ValueError(
                f"colorer must be one of {_COLORERS}, got {self.colorer!r}"
            )
        if self.gather not in _GATHERS:
            raise ValueError(
                f"gather must be one of {_GATHERS}, got {self.gather!r}"
            )
        if self.pipeline not in _PIPELINES:
            raise ValueError(
                f"pipeline must be one of {_PIPELINES}, got {self.pipeline!r}"
            )
        if self.backend != "auto" or self.interpret is not None:
            raise ValueError(
                "the port has no backend/interpret choice: plan(..., "
                "device='cuda') runs the CUDA kernels and device='cpu' their "
                "plain PyTorch versions"
            )
        vdt, idt = dtype_name(self.value_dtype), dtype_name(self.index_dtype)
        if vdt not in VALUE_DTYPES:
            raise ValueError(
                f"value_dtype must be one of {tuple(VALUE_DTYPES)}, got {vdt!r}"
            )
        if idt not in INDEX_DTYPES:
            raise ValueError(
                f"index_dtype must be one of {tuple(INDEX_DTYPES)}, got {idt!r}"
            )
        object.__setattr__(self, "value_dtype", vdt)
        object.__setattr__(self, "index_dtype", idt)


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Stream cost of one plan: the reference's stream-byte and waste
    fields.  ``waste_ratio`` is the padded/ragged stream ratio that
    drives ``layout="auto"``."""

    waste_ratio: float
    layout: str
    streamed_slots: int
    stream_bytes: int


def plan(
    matrix: Union[np.ndarray, torch.Tensor, COOMatrix, GustSchedule],
    config: Optional[PlanConfig] = None,
    *,
    cache: Optional[ScheduleCache] = default_cache,
    workers: Optional[int] = None,
    device="cuda",
    **overrides,
) -> "GustPlan":
    """Schedule ``matrix`` once and return a :class:`GustPlan` whose
    artifact lives on ``device``.

    ``matrix`` may be a dense 2-D array (numpy or torch), a
    :class:`COOMatrix`, or a :class:`GustSchedule` (whose ``l`` wins over
    the config's).  Scheduling is served from ``cache`` (content-keyed;
    ``cache=None`` bypasses it), so two plans over one matrix schedule
    once.  Keyword ``overrides`` are applied on top of ``config``.
    ``workers`` forwards to the window-chunked parallel colorer (None =
    auto); it never changes the schedule.  The device is checked before
    any scheduling work.
    """
    device = resolve_device(device)
    if config is None:
        config = PlanConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)

    if isinstance(matrix, GustSchedule):
        if matrix.l != config.l:
            config = dataclasses.replace(config, l=matrix.l)
        return GustPlan(config, matrix, cache=cache, device=device)

    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu().numpy()
    if isinstance(matrix, np.ndarray):
        if matrix.ndim != 2:
            raise ValueError(f"dense matrix must be 2-D, got shape {matrix.shape}")
        matrix = coo_from_dense(matrix)
    if not isinstance(matrix, COOMatrix):
        raise TypeError(
            "plan() takes a dense (numpy or torch) array, a COOMatrix or a "
            f"GustSchedule; got {type(matrix).__name__}"
        )
    if cache is None:
        sched = schedule(
            matrix, config.l, load_balance=config.load_balance,
            method=config.colorer, workers=workers,
        )
    else:
        sched = cache.schedule(
            matrix, config.l, load_balance=config.load_balance,
            method=config.colorer, workers=workers,
        )
    return GustPlan(config, sched, cache=cache, device=device, source=matrix)


class GustPlan:
    """Executable GUST artifact: schedule + packed layout on one device.

    Built by :func:`plan`.  Packing is lazy: the artifact materializes on
    first execution (or on reading :attr:`artifact`).  ``_source`` is the
    :class:`COOMatrix` the plan was scheduled from (``None`` when it was
    built from a :class:`GustSchedule`)."""

    def __init__(
        self,
        config: PlanConfig,
        sched: GustSchedule,
        *,
        cache: Optional[ScheduleCache] = None,
        device="cuda",
        source: Optional[COOMatrix] = None,
    ):
        self.config = config
        self.sched = sched
        self.cache = cache
        self.device = resolve_device(device)
        self._source = source
        self._artifact: Optional[Union[PackedSchedule, RaggedSchedule]] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.sched.shape

    @property
    def l(self) -> int:
        return self.config.l

    @property
    def layout(self) -> str:
        """Resolved layout (``auto`` is decided from the measured waste)."""
        if self.config.layout != "auto":
            return self.config.layout
        return resolve_layout(
            self.sched, self.config.c_blk, self.config.waste_threshold
        )

    @property
    def artifact(self) -> Union[PackedSchedule, RaggedSchedule]:
        """The packed execution layout; materialized on first use."""
        if self._artifact is None:
            self._artifact = self._pack()
        return self._artifact

    @property
    def gather_mode(self) -> str:
        """Resolved gather mode (``auto`` is decided from the packed
        artifact's ``S_blk / seg_count`` locality — reading this packs a
        lazy plan)."""
        if self.config.gather != "auto":
            return self.config.gather
        a = self.artifact
        return resolve_gather(a.s_blk, a.seg_count)

    def _pipeline(self) -> str:
        """Resolved streaming mode: ``auto`` means double-buffered, as on
        the reference's kernel path (the plain versions ignore it)."""
        return "double" if self.config.pipeline == "auto" else self.config.pipeline

    def _pack(self):
        c = self.config
        ragged = self.layout == "ragged"
        if self.cache is not None:
            route = self.cache.ragged_for if ragged else self.cache.pack_for
            return route(
                self.sched, c_blk=c.c_blk, value_dtype=c.value_dtype,
                index_dtype=c.index_dtype, device=self.device,
            )
        fn = pack_ragged if ragged else pack_schedule
        return fn(
            self.sched, c.c_blk, c.value_dtype, c.index_dtype, device=self.device
        )

    def spmm(self, x, *, transpose_io: bool = False) -> torch.Tensor:
        """Multi-vector execution: ``x (n, B) -> y (m, B)``, or batch-major
        ``x (B, n) -> y (B, m)`` with ``transpose_io=True``.  ``x`` (a
        tensor or numpy array) is moved to the plan's device."""
        x = torch.as_tensor(x, device=self.device)
        return execute_spmm(
            self.artifact,
            x,
            c_blk=self.config.c_blk,
            transpose_io=transpose_io,
            gather=self.config.gather,
            pipeline=self._pipeline(),
        )

    def spmv(self, v) -> torch.Tensor:
        """Single-vector execution: ``v (n,) -> y (m,)``."""
        v = torch.as_tensor(v, device=self.device)
        n = self.shape[1]
        if tuple(v.shape) != (n,):
            raise ValueError(f"vector shape {tuple(v.shape)} != ({n},)")
        return self.spmm(v[:, None])[:, 0]

    def spgemm(self, other) -> COOMatrix:
        """Sparse x sparse ``C = A @ B`` through this plan's color-block
        stream (``other``: a :class:`COOMatrix`, a dense array, or another
        plan built from a matrix).  On the card it runs the SpGEMM kernel,
        on the CPU its plain version.  Returns a deduplicated, row-sorted
        :class:`COOMatrix` without explicit zeros, which can itself be
        planned.  See :mod:`repro_torch.core.spgemm`."""
        from .spgemm import spgemm as _spgemm

        return _spgemm(self, other)

    def spgemm_cost(self, other) -> SpgemmCost:
        """Predicted cost of ``self @ other`` (output-nnz estimate,
        accumulator bytes, partial products, FLOP reduction against a dense
        product) without packing or executing.  See
        :class:`repro_torch.core.spgemm.SpgemmCost`."""
        from .spgemm import spgemm_cost as _spgemm_cost

        return _spgemm_cost(self, other)

    def cost(self) -> PlanCost:
        """Stream bytes and padding waste of this plan (packs a lazy plan)."""
        a = self.artifact
        return PlanCost(
            waste_ratio=ragged_waste_ratio(self.sched, self.config.c_blk),
            layout=self.layout,
            streamed_slots=a.streamed_slots,
            stream_bytes=a.stream_bytes,
        )

    def __repr__(self) -> str:
        m, n = self.shape
        packed = "lazy" if self._artifact is None else self.layout
        return (
            f"GustPlan({m}x{n}, l={self.l}, layout={self.config.layout}"
            f"->{packed}, device={self.device})"
        )
