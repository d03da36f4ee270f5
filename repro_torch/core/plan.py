"""GustPlan — the plan/execute API of the port.

Counterpart of ``repro.core.plan``: schedule a matrix once, pack it
lazily on the plan's device, and execute it against any number of
vectors.

    >>> import repro_torch
    >>> p = repro_torch.plan(matrix, repro_torch.PlanConfig(l=256))
    >>> y = p.spmv(v)     # on the card, through the CUDA kernels
    >>> Y = p.spmm(X)
    >>> C = p.spgemm(B)   # sparse x sparse, a COOMatrix
    >>> p.cost()          # measured + Eq. 9-11 predicted cost
    >>> spec = p.to_spec()                    # leaves/meta wire format
    >>> stacked = repro_torch.GustPlan.stack([p, q])   # serving stacks
    >>> tuned = p.tune(X)                     # measured autotuning
    >>> p2 = repro_torch.reschedule(p, matrix2)       # dirty windows only
    >>> p.shard(mesh).spmv(v)  # k parallel length-l GUSTs (paper §5.5)

The device decides the execution path: ``device="cuda"`` (the default;
it raises when no card is present) runs the hand-written kernels,
``device="cpu"`` their plain PyTorch versions.  Execution is never
retried on another path when it fails: the reference degrades a failed
kernel to its jnp path and a failed segment-local gather to the resident
one, the port lets the error reach the caller (``cost().fallback_kernel``
and ``fallback_gather`` stay 0).  The one fallback it applies is the
store's: a read that exhausts its retries is served by a fresh plan,
bit for bit the stored one (``fallback_store``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.ops import execute_spmm
from ..resilience import faults
from ..resilience.fallback import record_fallback
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
    packed_from_leaves,
    packed_leaves,
    packed_meta,
    packed_spec,
    ragged_from_leaves,
    ragged_leaves,
    ragged_meta,
    ragged_spec,
    ragged_waste_ratio,
    resolve_device,
    resolve_gather,
    resolve_layout,
    resolve_tuning,
    splice_ragged_blocks,
)
from .scheduler import schedule

if TYPE_CHECKING:  # pragma: no cover
    from .spgemm import SpgemmCost

__all__ = [
    "PlanConfig",
    "PlanCost",
    "TuneResult",
    "GustPlan",
    "plan",
    "reschedule",
    "RescheduleResult",
]

_LAYOUTS = ("padded", "ragged", "auto")
_BACKENDS = ("jnp", "pallas", "auto")
_COLORERS = ("paper", "fast", "exact")
_GATHERS = ("resident", "local", "auto")
_PIPELINES = ("single", "double", "auto")

#: The reference's knobs that choose between its Pallas and jnp paths; in
#: the port the plan's device chooses.
_EXECUTION_ONLY = ("backend", "interpret")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Every knob of the schedule→pack→execute pipeline — the reference's
    fields, with its defaults.

    ``backend`` and ``interpret`` choose between the reference's Pallas
    and jnp paths; in the port the plan's device chooses, so they must be
    left at ``"auto"`` and ``None``.  ``mesh_axis`` is the default mesh
    dim of :meth:`GustPlan.shard`.  With
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

    def to_dict(self) -> Dict:
        """Plain-JSON form (the config part of :meth:`GustPlan.to_spec`)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "PlanConfig":
        """Inverse of :meth:`to_dict`; unknown keys are dropped.  A
        reference config's ``backend``/``interpret`` (its Pallas or jnp
        path) are dropped too: the plan's device chooses the path."""
        known = {f.name for f in dataclasses.fields(cls)} - set(_EXECUTION_ONLY)
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Measured + predicted cost of one plan, with the reference's field
    names.

    ``cycles``/``utilization`` come from the schedule; ``waste_ratio`` is
    the padded/ragged stream ratio that drives ``layout="auto"``;
    ``expected_*`` are the Eq. 9-11 bounds at the matrix's density.

    Gather locality: ``s_blk`` / ``locality_ratio`` (the ``gather="auto"``
    signal); ``gather_flops_resident`` / ``gather_flops_local`` are the
    reference's one-hot gather FLOPs per vector column (``4 · slots ·
    seg_count`` against ``4 · slots · S_blk``), kept for comparison: the
    port's kernels read ``x[col]`` directly.  ``x_vmem_bytes_resident`` /
    ``x_vmem_bytes_local`` are x's f32 bytes per vector column that each
    gather keeps at hand: the whole padded vector against one block's
    tiles.

    ``backend`` is ``"cuda"`` (the kernels) or ``"plain"`` (their plain
    PyTorch versions), ``pipeline`` the resolved one.  Cache and store
    counters are the plan's at cost time.  ``fallback_kernel`` and
    ``fallback_gather`` are always 0 in the port (no execution fallback);
    ``fallback_store`` counts store reads served by a fresh plan.
    """

    cycles: int
    utilization: float
    waste_ratio: float
    layout: str
    streamed_slots: int
    stream_bytes: int
    density: float
    expected_colors: float
    expected_cycles: float
    expected_utilization: float
    gather: str
    s_blk: int
    locality_ratio: float
    gather_flops_resident: int
    gather_flops_local: int
    x_vmem_bytes_resident: int
    x_vmem_bytes_local: int
    backend: str = "cuda"
    pipeline: str = "double"
    cache_hits: int = 0
    cache_misses: int = 0
    cache_entries: int = 0
    cache_evictions: int = 0
    store_hits: int = 0
    store_misses: int = 0
    fallback_kernel: int = 0
    fallback_gather: int = 0
    fallback_store: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


TuneKey = Tuple[int, int, str, str]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Record of one measured :meth:`GustPlan.tune` sweep.

    Candidate keys are ``(c_blk, l, layout, gather)``.  ``choice`` is the
    winner of :func:`~repro_torch.core.packing.resolve_tuning`: the
    fastest measured candidate unless it fails to beat ``baseline`` (the
    plan's static layout/gather resolution) by the margin.
    ``cost_consistent``: the winner streams no more bytes than the
    baseline.  ``pruned``: candidates whose predicted stream bytes passed
    ``prune_ratio`` × the least, never timed.  Times are seconds."""

    choice: TuneKey
    baseline: TuneKey
    measurements: Dict[TuneKey, float]
    predicted_bytes: Dict[TuneKey, int]
    improvement: float
    cost_consistent: bool
    pruned: Tuple[TuneKey, ...] = ()

    def to_dict(self) -> Dict:
        key = lambda k: f"c_blk={k[0]},l={k[1]},layout={k[2]},gather={k[3]}"
        return {
            "choice": key(self.choice),
            "baseline": key(self.baseline),
            "measurements": {key(k): v for k, v in self.measurements.items()},
            "predicted_bytes": {
                key(k): v for k, v in self.predicted_bytes.items()
            },
            "improvement": self.improvement,
            "cost_consistent": self.cost_consistent,
            "pruned": [key(k) for k in self.pruned],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TuneResult":
        """Inverse of :meth:`to_dict`: how a store warm load revives the
        recorded sweep."""

        def parse(s: str) -> TuneKey:
            kv = dict(part.split("=", 1) for part in s.split(","))
            return (int(kv["c_blk"]), int(kv["l"]), kv["layout"], kv["gather"])

        return cls(
            choice=parse(d["choice"]),
            baseline=parse(d["baseline"]),
            measurements={parse(k): v for k, v in d["measurements"].items()},
            predicted_bytes={
                parse(k): v for k, v in d["predicted_bytes"].items()
            },
            improvement=d["improvement"],
            cost_consistent=d["cost_consistent"],
            pruned=tuple(parse(k) for k in d.get("pruned", [])),
        )


def _as_coo(matrix, who: str) -> COOMatrix:
    """A dense 2-D array (numpy or torch) or a COOMatrix as a COOMatrix."""
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu().numpy()
    if isinstance(matrix, np.ndarray):
        if matrix.ndim != 2:
            raise ValueError(f"dense matrix must be 2-D, got shape {matrix.shape}")
        matrix = coo_from_dense(matrix)
    if not isinstance(matrix, COOMatrix):
        raise TypeError(
            f"{who} takes a dense (numpy or torch) array or a COOMatrix; got "
            f"{type(matrix).__name__}"
        )
    return matrix


def plan(
    matrix: Union[np.ndarray, torch.Tensor, COOMatrix, GustSchedule],
    config: Optional[PlanConfig] = None,
    *,
    cache: Optional[ScheduleCache] = default_cache,
    store=None,
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

    ``store`` (a :class:`~repro_torch.core.plan_store.PlanStore`) carries
    the artifact across processes: on a hit its leaves are loaded onto
    ``device`` with no coloring or packing; on a miss the fresh plan
    writes its artifact (and any ``TuneResult``) when the pack first
    materializes.  A store-loaded plan executes bit for bit as the fresh
    one but carries no schedule (``cost()``, ``tune()`` and
    ``reschedule()`` need a fresh plan).
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

    matrix = _as_coo(matrix, "plan()")

    store_key, store_fallbacks = None, 0
    if store is not None:
        store_key = store.key(ScheduleCache.matrix_key(matrix), config)
        io0 = store.io_errors
        record = store.get(store_key)
        if record is None and store.io_errors > io0:
            # the read failed after the store's retries: stored -> fresh,
            # bit for bit the stored plan, counted on the fresh plan
            record_fallback("store")
            store_fallbacks = 1
        if record is not None:
            spec = record["spec"]
            spec = dict(spec, leaves={k: v.to(device) for k, v in spec["leaves"].items()})
            p = GustPlan.from_spec(spec, config=config, cache=cache)
            p._source = matrix
            p._store, p._store_key, p._store_loaded = store, store_key, True
            if record.get("tuning"):
                p.tuning = TuneResult.from_dict(record["tuning"])
            p.summary = record.get("summary")
            return p

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
    p = GustPlan(config, sched, cache=cache, device=device, source=matrix)
    p._store, p._store_key = store, store_key
    p._fallbacks["store"] = store_fallbacks
    return p


class GustPlan:
    """Executable GUST artifact: schedule + packed layout on one device.

    Built by :func:`plan` (or :meth:`from_spec` / :meth:`from_artifact` /
    :meth:`spec_for`).  Packing is lazy: the artifact materializes on
    first execution (or on reading :attr:`artifact`).  ``_source`` is the
    :class:`COOMatrix` the plan was scheduled from, when known (``tune``
    sweeps ``l`` and ``reschedule`` diffs windows through it).  A plan
    built from a shape-only artifact lives on the meta device and does
    not execute.  A plan from :meth:`shard` carries ``mesh`` and
    ``axis`` and executes only :meth:`spmv`."""

    def __init__(
        self,
        config: PlanConfig,
        sched: Optional[GustSchedule] = None,
        *,
        artifact: Optional[Union[PackedSchedule, RaggedSchedule]] = None,
        cache: Optional[ScheduleCache] = None,
        device="cuda",
        source: Optional[COOMatrix] = None,
        mesh=None,
        axis: Optional[str] = None,
    ):
        if sched is None and artifact is None:
            raise ValueError("a GustPlan needs a schedule or a packed artifact")
        self.config = config
        self.sched = sched
        self.cache = cache
        self.mesh = mesh
        self.axis = axis
        if artifact is not None and artifact.device.type == "meta":
            self.device = artifact.device
        else:
            self.device = resolve_device(device)
        self._artifact = artifact
        self._source = source
        self.tuning: Optional[TuneResult] = None
        # PlanStore attachment: a fresh plan writes its artifact when it
        # first packs; a loaded one carries the stored schedule summary.
        self._store = None
        self._store_key: Optional[str] = None
        self._store_loaded = False
        self.summary: Optional[Dict] = None
        # Fallbacks applied on this plan's path (PlanCost.fallback_*): the
        # port applies only the store's.
        self._fallbacks: Dict[str, int] = {"kernel": 0, "gather": 0, "store": 0}
        # reschedule(): per-window fingerprints of the source, last delta.
        self._window_hashes: Optional[np.ndarray] = None
        self.resched: Optional[RescheduleResult] = None

    # -- identity ----------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        src = self.sched if self.sched is not None else self._artifact
        return tuple(src.shape)

    @property
    def l(self) -> int:
        return self.config.l

    @property
    def layout(self) -> str:
        """Resolved layout (``auto`` is decided from the measured waste)."""
        if self._artifact is not None:
            return "ragged" if isinstance(self._artifact, RaggedSchedule) else "padded"
        if self.config.layout != "auto":
            return self.config.layout
        return resolve_layout(
            self.sched, self.config.c_blk, self.config.waste_threshold
        )

    @property
    def artifact(self) -> Union[PackedSchedule, RaggedSchedule]:
        """The packed execution layout; materialized on first use, when a
        fresh plan with a store also writes it."""
        if self._artifact is None:
            faults.trip("pack.materialize")
            self._artifact = self._pack()
            self._store_put()
        return self._artifact

    def verify(self):
        """Run the static artifact verifier over the packed leaves and
        return the list of :class:`~repro_torch.analysis.verify.Finding`
        violations (empty on a healthy artifact).  Packs a lazy plan;
        host numpy over one copy of each leaf, never a kernel."""
        from ..analysis.verify import verify as _verify

        return _verify(self.artifact)

    def _store_put(self) -> None:
        """Write-behind of the artifact (plus tuning and a schedule
        summary).  A failed write (``OSError``, an injected store fault)
        leaves the plan as it is: persistence never stops execution."""
        if self._store is None or self._store_key is None or self._store_loaded:
            return
        summary = None
        if self.sched is not None:
            summary = {
                "cycles": int(self.sched.cycles),
                "nnz": int(self.sched.nnz),
                "utilization": float(self.sched.hardware_utilization),
            }
        try:
            self._store.put(
                self._store_key,
                self.to_spec(),
                tuning=self.tuning.to_dict() if self.tuning else None,
                summary=summary,
            )
        except (OSError, faults.FaultError):
            pass

    @property
    def gather_mode(self) -> str:
        """Resolved gather mode (``auto`` is decided from the packed
        artifact's ``S_blk / seg_count`` locality — reading this packs a
        lazy plan)."""
        if self.config.gather != "auto":
            return self.config.gather
        a = self.artifact
        return resolve_gather(a.s_blk, a.seg_count)

    def _backend(self) -> str:
        return "cuda" if self.device.type == "cuda" else "plain"

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

    # -- execution ---------------------------------------------------------

    def spmm(self, x, *, transpose_io: bool = False) -> torch.Tensor:
        """Multi-vector execution: ``x (n, B) -> y (m, B)``, or batch-major
        ``x (B, n) -> y (B, m)`` with ``transpose_io=True``.  ``x`` (a
        tensor or numpy array) is moved to the plan's device.  A failure
        propagates: no other path is tried."""
        if self.mesh is not None:
            raise NotImplementedError(
                "sharded plans execute single vectors; use .spmv(v) "
                "(the §5.5 row-window split concatenates per-device outputs)"
            )
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
        """Single-vector execution: ``v (n,) -> y (m,)``.  On a sharded
        plan (:meth:`shard`) each rank runs its own window range and the
        outputs are gathered over the mesh dim."""
        v = torch.as_tensor(v, device=self.device)
        n = self.shape[1]
        if tuple(v.shape) != (n,):
            raise ValueError(f"vector shape {tuple(v.shape)} != ({n},)")
        if self.mesh is not None:
            return self._spmv_sharded(v)
        return self.spmm(v[:, None])[:, 0]

    def spgemm(self, other) -> COOMatrix:
        """Sparse x sparse ``C = A @ B`` through this plan's color-block
        stream (``other``: a :class:`COOMatrix`, a dense array, or another
        plan built from a matrix).  On the card it runs the SpGEMM kernel,
        on the CPU its plain version.  Returns a deduplicated, row-sorted
        :class:`COOMatrix` without explicit zeros, which can itself be
        planned.  See :mod:`repro_torch.core.spgemm`."""
        from .spgemm import spgemm as _spgemm

        if self.mesh is not None:
            raise NotImplementedError(
                "spgemm on a sharded plan is not supported; call it on "
                "the unsharded plan"
            )
        return _spgemm(self, other)

    def spgemm_cost(self, other) -> SpgemmCost:
        """Predicted cost of ``self @ other`` (output-nnz estimate,
        accumulator bytes, partial products, FLOP reduction against a dense
        product) without packing or executing.  See
        :class:`repro_torch.core.spgemm.SpgemmCost`."""
        from .spgemm import spgemm_cost as _spgemm_cost

        return _spgemm_cost(self, other)

    # -- distributed execution ------------------------------------------------

    def shard(self, mesh, axis: Optional[str] = None) -> "GustPlan":
        """A plan that executes as ``mesh``'s ``axis`` size parallel
        length-l GUSTs (paper §5.5: "the Edge-Coloring schedule would not
        need to change").  ``mesh`` is a ``DeviceMesh``; this process is
        one rank of its ``axis`` dim.  Ranks own contiguous window ranges
        balanced by ragged-stream block count (:func:`_shard_layout`);
        each runs its range, a :class:`RaggedSchedule` of its own
        (:func:`rank_artifact`), through the kernel the unsharded plan
        would pick, on this plan's device.  The layout is memoized in the
        plan's :class:`ScheduleCache` next to the pack.  Sharding needs
        the ragged stream: a padded plan re-packs ragged through the
        cache, and a padded spec-plan (no schedule) cannot be sharded."""
        axis = axis if axis is not None else self.config.mesh_axis
        ragged_art = self._artifact if isinstance(self._artifact, RaggedSchedule) else None
        if ragged_art is None and self.sched is None:
            raise ValueError(
                "cannot shard a padded spec-plan: the ragged stream needs "
                "the schedule (build the plan with plan(...) or a ragged "
                "artifact)"
            )
        return GustPlan(
            dataclasses.replace(self.config, layout="ragged", mesh_axis=axis),
            self.sched,
            artifact=ragged_art,
            cache=self.cache,
            device=self.device,
            mesh=mesh,
            axis=axis,
        )

    def _cached_layout(self, n_dev: int) -> "ShardLayout":
        c = self.config
        if self.cache is not None and self.sched is not None:
            # one entry per (schedule content, c_blk, dtypes, n_dev)
            return self.cache.memo(
                ("shard_layout", self.cache.schedule_key(self.sched),
                 c.c_blk, c.value_dtype, c.index_dtype, n_dev),
                lambda: _shard_layout(self.artifact, n_dev),
            )
        return _shard_layout(self.artifact, n_dev)

    def _rank_part(self, n_dev: int, rank: int):
        """(layout with its ``idx`` on this plan's device, this rank's
        artifact), memoized in the cache beside the layout: a sharded
        ``spmv`` slices and copies nothing after its first call."""
        def build():
            layout = self._cached_layout(n_dev)
            return (dataclasses.replace(layout, idx=layout.idx.to(self.device)),
                    rank_artifact(self.artifact, layout, rank))

        c = self.config
        if self.cache is not None and self.sched is not None:
            return self.cache.memo(
                ("shard_rank", self.cache.schedule_key(self.sched), c.c_blk,
                 c.value_dtype, c.index_dtype, n_dev, rank, str(self.device)),
                build,
            )
        return build()

    def _spmv_sharded(self, v: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        group = self.mesh.get_group(self.axis)
        n_dev = dist.get_world_size(group)
        rank = self.mesh.get_local_rank(self.axis)
        layout, art = self._rank_part(n_dev, rank)
        y_pad = self.rank_spmv(art, v, layout.w_max)
        y_dev = torch.empty(n_dev * y_pad.numel(), dtype=torch.float32, device=self.device)
        dist.all_gather_into_tensor(y_dev, y_pad, group=group)
        return self.reassemble(y_dev, layout).to(v.dtype)

    def rank_spmv(self, art: Optional[RaggedSchedule], v: torch.Tensor,
                  w_max: int) -> torch.Tensor:
        """One rank's part of a sharded ``spmv``: its artifact (from
        :func:`rank_artifact`) through the kernel this plan's gather and
        pipeline pick, its ``w_cnt * l`` rows zero-padded to ``w_max * l``
        (f32).  A rank with no window (``art`` None) launches nothing."""
        l = self.config.l
        y_pad = torch.zeros(w_max * l, dtype=torch.float32, device=self.device)
        if art is not None:
            y_pad[: art.num_windows * l] = execute_spmm(
                art, v[:, None], c_blk=self.config.c_blk, gather=self.config.gather,
                pipeline=self._pipeline(),
            )[:, 0].float()
        return y_pad

    def reassemble(self, y_dev: torch.Tensor, layout: "ShardLayout") -> torch.Tensor:
        """The ranks' padded outputs, concatenated in rank order (what the
        all-gather gives), as ``y`` (m,): rank d's first ``w_cnt[d] * l``
        rows are its window range in order; then the load-balancing row
        sort is undone as the unsharded executor undoes it."""
        a = self.artifact
        y_sorted = y_dev[layout.idx.to(self.device)]
        m = self.shape[0]
        if a.identity_perm:
            return y_sorted[:m]
        out = torch.zeros(max(m, a.num_windows * a.l), dtype=torch.float32,
                          device=self.device)
        out[a.row_perm.long()] = y_sorted
        return out[:m]

    # -- multi-layer serving -------------------------------------------------

    @staticmethod
    def stack(plans: Sequence[Union["GustPlan", PackedSchedule, RaggedSchedule]]) -> Dict:
        """Stack the artifacts of ``plans`` (one per layer) along a leading
        axis.  Layers are first equalized to one stream length
        (``repad_to`` / ``repad_to_blocks``) and one table width
        (``repad_seg_to``), keeping the padding invariants and leaf dtypes;
        ``identity_perm`` and ``fusable`` hold only if they hold for every
        layer.  Returns the ``{"leaves", "meta"}`` wire format that
        :meth:`from_spec` takes one layer's slice of."""
        arts = [p.artifact if isinstance(p, GustPlan) else p for p in plans]
        if not arts:
            raise ValueError("stack() needs at least one plan")
        ragged = isinstance(arts[0], RaggedSchedule)
        if any(isinstance(a, RaggedSchedule) != ragged for a in arts):
            raise ValueError("cannot stack mixed padded/ragged layouts")
        if any(a.quantized != arts[0].quantized for a in arts):
            # scale_blk exists only on quantized artifacts: no common leaves
            raise ValueError(
                "cannot stack mixed quantized/unquantized layers: pack "
                "every layer with the same value_dtype"
            )
        if ragged:
            t_uniform = max(a.num_blocks for a in arts)
            arts = [a.repad_to_blocks(t_uniform) for a in arts]
        else:
            c_uniform = max(a.c_pad for a in arts)
            arts = [a.repad_to(c_uniform) for a in arts]
        s_uniform = max(a.s_blk for a in arts)
        arts = [a.repad_seg_to(s_uniform) for a in arts]
        ident = all(a.identity_perm for a in arts)
        fusable = all(a.fusable for a in arts)
        arts = [
            dataclasses.replace(a, identity_perm=ident, fusable=fusable)
            for a in arts
        ]
        if ragged:
            leaf_fn, meta = ragged_leaves, ragged_meta(arts[0])
        else:
            leaf_fn, meta = packed_leaves, packed_meta(arts[0])
        per_layer = [leaf_fn(a) for a in arts]
        leaves = {k: torch.stack([d[k] for d in per_layer]) for k in per_layer[0]}
        return {"leaves": leaves, "meta": meta}

    # -- serialization (the leaves/meta codec) -------------------------------

    def to_spec(self) -> Dict:
        """``{"leaves", "meta", "config"}`` — the wire format shared with
        serving stacks and the store.  ``leaves`` are the artifact's
        tensors at their exact dtypes; ``meta`` and ``config`` are static
        and JSON-able."""
        a = self.artifact
        if isinstance(a, RaggedSchedule):
            leaves, meta = ragged_leaves(a), ragged_meta(a)
        else:
            leaves, meta = packed_leaves(a), packed_meta(a)
        return {"leaves": leaves, "meta": meta, "config": self.config.to_dict()}

    @classmethod
    def from_spec(
        cls,
        spec: Dict,
        *,
        config: Optional[PlanConfig] = None,
        cache: Optional[ScheduleCache] = None,
    ) -> "GustPlan":
        """Rebuild a plan from :meth:`to_spec` output (or one layer's slice
        of a :meth:`stack`) on its leaves' device.  The schedule is not
        serialized: the plan executes but cannot re-pack."""
        meta = tuple(spec["meta"])
        if meta and meta[0] == "ragged":
            artifact = ragged_from_leaves(spec["leaves"], meta)
        else:
            artifact = packed_from_leaves(spec["leaves"], meta)
        if config is None:
            cfg_dict = spec.get("config")
            config = PlanConfig.from_dict(cfg_dict) if cfg_dict else PlanConfig()
        return cls.from_artifact(artifact, config=config, cache=cache)

    @classmethod
    def from_artifact(
        cls,
        artifact: Union[PackedSchedule, RaggedSchedule],
        *,
        config: Optional[PlanConfig] = None,
        c_blk: Optional[int] = None,
        cache: Optional[ScheduleCache] = None,
        sched: Optional[GustSchedule] = None,
    ) -> "GustPlan":
        """Wrap a packed artifact in a plan on the artifact's device.
        Layout, geometry and dtypes are read off the artifact; ``c_blk``
        overrides the config's on a padded unquantized stream (ragged and
        quantized streams run at their pack-time height)."""
        if config is None:
            config = PlanConfig()
        ragged = isinstance(artifact, RaggedSchedule)
        config = dataclasses.replace(
            config,
            l=artifact.l,
            layout="ragged" if ragged else "padded",
            c_blk=artifact.c_blk if (ragged or artifact.quantized) else (
                c_blk if c_blk is not None else config.c_blk
            ),
            value_dtype=dtype_name(artifact.m_blk.dtype),
            index_dtype=dtype_name(artifact.col_blk.dtype),
        )
        return cls(config, sched, artifact=artifact, cache=cache,
                   device=artifact.device)

    @classmethod
    def spec_for(
        cls, m: int, n: int, config: PlanConfig, *, colors: float
    ) -> "GustPlan":
        """Shape-only plan (meta-device leaves, no allocation) with the
        stream sized from a per-window color estimate, typically the Eq. 9
        bound: how memory is accounted without running the scheduler."""
        c = config
        layout = "padded" if c.layout == "auto" else c.layout
        cpb = max(-(-int(np.ceil(colors)) // c.c_blk), 1)
        if layout == "ragged":
            artifact = ragged_spec(
                m, n, c.l, max(-(-m // c.l), 1) * cpb, c_blk=c.c_blk,
                value_dtype=c.value_dtype, index_dtype=c.index_dtype,
            )
        else:
            artifact = packed_spec(
                m, n, c.l, cpb * c.c_blk, c_blk=c.c_blk,
                value_dtype=c.value_dtype, index_dtype=c.index_dtype,
            )
        return cls(dataclasses.replace(c, layout=layout), artifact=artifact)

    # -- measured autotuning -------------------------------------------------

    def tune(
        self,
        x_probe,
        *,
        c_blks: Optional[Sequence[int]] = None,
        ls: Optional[Sequence[int]] = None,
        layouts: Sequence[str] = ("padded", "ragged"),
        gathers: Sequence[str] = ("resident", "local"),
        iters: int = 3,
        warmup: int = 1,
        min_improvement: Optional[float] = None,
        prune_ratio: float = 4.0,
    ) -> "GustPlan":
        """Measure ``(c_blk, l, layout, gather)`` candidates on ``x_probe``
        (``(n,)`` or ``(n, B)``) and return a plan pinned to the winner.

        Each candidate is priced by :class:`PlanCost` first (predicted
        stream bytes past ``prune_ratio`` × the least are pruned untimed),
        then timed on the plan's device: best of ``iters`` calls after
        ``warmup``, each between ``torch.cuda.synchronize()`` calls on the
        card (``time.perf_counter`` on the CPU).  The winner comes from
        :func:`~repro_torch.core.packing.resolve_tuning`: the fastest,
        unless it fails to beat the static baseline by the margin.  The
        returned plan carries the :class:`TuneResult` on ``.tuning`` and a
        config that spells every swept knob.  The sweep is memoized in the
        plan's cache, keyed on schedule content, probe, knobs and device.

        ``ls`` defaults to the plan's ``l`` plus ``l/2`` when the plan
        holds its source matrix (another ``l`` means rescheduling).
        """
        if self.mesh is not None:
            raise NotImplementedError("tune a plan before sharding it")
        if self.sched is None:
            raise ValueError(
                "tune() needs the schedule; deserialized/spec plans carry "
                "only the packed artifact"
            )
        x_probe = torch.as_tensor(x_probe, device=self.device)
        if x_probe.dim() == 1:
            x_probe = x_probe[:, None]
        c = self.config
        if c_blks is None:
            c_blks = tuple(sorted({4, c.c_blk, 2 * c.c_blk}))
        if ls is None:
            ls = (
                tuple(sorted({c.l, max(c.l // 2, 1)}, reverse=True))
                if self._source is not None
                else (c.l,)
            )
        baseline = (c.c_blk, c.l, self.layout, self.gather_mode)

        def build(key: TuneKey) -> "GustPlan":
            cb, l, layout, gather = key
            cfg = dataclasses.replace(c, c_blk=cb, l=l, layout=layout, gather=gather)
            if l == c.l:
                return GustPlan(cfg, self.sched, cache=self.cache,
                                device=self.device, source=self._source)
            return plan(self._source, cfg, cache=self.cache, device=self.device)

        candidates = {baseline}
        for cb in c_blks:
            for l in ls:
                if l != c.l and self._source is None:
                    continue
                for layout in layouts:
                    for gather in gathers:
                        candidates.add((int(cb), int(l), layout, gather))
        candidates = sorted(candidates)
        on_card = self.device.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize(self.device)

        def seconds(run) -> float:
            for _ in range(max(warmup, 1)):
                run(x_probe)
            best = float("inf")
            for _ in range(max(iters, 1)):
                sync()
                t0 = time.perf_counter()
                run(x_probe)
                sync()
                best = min(best, time.perf_counter() - t0)
            return best

        def sweep() -> TuneResult:
            predicted, plans = {}, {}
            for key in candidates:
                plans[key] = build(key)
                predicted[key] = int(plans[key].cost().stream_bytes)
            least = min(predicted.values())
            pruned = tuple(
                k for k in candidates
                if k != baseline and predicted[k] > prune_ratio * least
            )
            measurements = {
                key: seconds(plans[key].spmm) for key in candidates if key not in pruned
            }
            choice = resolve_tuning(
                measurements, baseline, min_improvement=min_improvement
            )
            return TuneResult(
                choice=choice,
                baseline=baseline,
                measurements=measurements,
                predicted_bytes=predicted,
                improvement=measurements[baseline] / measurements[choice],
                cost_consistent=predicted[choice] <= predicted[baseline],
                pruned=pruned,
            )

        if self.cache is not None:
            memo_key = (
                "tune", self.cache.schedule_key(self.sched), tuple(candidates),
                tuple(x_probe.shape), str(x_probe.dtype), c.value_dtype,
                c.index_dtype, str(self.device), iters, warmup, min_improvement,
                prune_ratio,
            )
            result = self.cache.memo(memo_key, sweep)
        else:
            result = sweep()
        tuned = build(result.choice)
        tuned.tuning = result
        if self._store is not None and self._source is not None:
            # persist the winner under the tuned config's key, so a warm
            # load revives the artifact and the TuneResult together
            tuned._store = self._store
            tuned._store_key = self._store.key(
                ScheduleCache.matrix_key(self._source), tuned.config
            )
        return tuned

    # -- cost ----------------------------------------------------------------

    def cost(self) -> PlanCost:
        """Measured schedule cost + Eq. 9-11 predictions (packs a lazy
        plan)."""
        from .bounds import (
            expected_colors_bound,
            expected_execution_cycles,
            expected_utilization,
        )

        if self.sched is None:
            raise ValueError(
                "cost() needs the schedule; deserialized/spec plans carry "
                "only the packed artifact"
            )
        m, n = self.shape
        density = self.sched.nnz / float(m * n) if m and n else 0.0
        a = self.artifact
        streamed = a.streamed_slots
        cache = self.cache.stats() if self.cache is not None else {}
        return PlanCost(
            cycles=self.sched.cycles,
            utilization=self.sched.hardware_utilization,
            waste_ratio=ragged_waste_ratio(self.sched, self.config.c_blk),
            layout=self.layout,
            streamed_slots=streamed,
            stream_bytes=a.stream_bytes,
            density=density,
            expected_colors=float(expected_colors_bound(n, density, self.l)),
            expected_cycles=float(expected_execution_cycles(n, density, self.l)),
            expected_utilization=float(expected_utilization(n, density, self.l)),
            gather=self.gather_mode,
            s_blk=a.s_blk,
            locality_ratio=a.s_blk / max(a.seg_count, 1),
            gather_flops_resident=4 * streamed * a.seg_count,
            gather_flops_local=4 * streamed * a.s_blk,
            x_vmem_bytes_resident=a.seg_count * self.l * 4,
            x_vmem_bytes_local=a.s_blk * self.l * 4,
            backend=self._backend(),
            pipeline=self._pipeline(),
            store_hits=self._store.hits if self._store is not None else 0,
            store_misses=self._store.misses if self._store is not None else 0,
            fallback_kernel=self._fallbacks["kernel"],
            fallback_gather=self._fallbacks["gather"],
            fallback_store=self._fallbacks["store"],
            **{f"cache_{k}": v for k, v in cache.items()},
        )

    def __repr__(self) -> str:
        m, n = self.shape
        packed = "lazy" if self._artifact is None else self.layout
        shard = f", sharded[{self.axis}]" if self.mesh is not None else ""
        return (
            f"GustPlan({m}x{n}, l={self.l}, layout={self.config.layout}"
            f"->{packed}, device={self.device}{shard})"
        )


# ---------------------------------------------------------------------------
# Distributed execution internals (owned by GustPlan.shard)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Contiguous window ranges of a ragged stream over ``n_dev`` ranks:
    rank ``d`` owns windows ``w_bound[d]:w_bound[d+1]`` (``w_cnt[d]`` of
    them, ``b_cnt[d]`` blocks); ``b_max`` / ``w_max`` are the largest
    counts (at least 1), and ``idx`` gathers the ranks' ``w_max * l``-row
    outputs, concatenated in rank order, into scheduled row order."""

    w_bound: np.ndarray
    w_cnt: np.ndarray
    b_cnt: np.ndarray
    b_max: int
    w_max: int
    idx: torch.Tensor


def _shard_layout(ragged: RaggedSchedule, n_dev: int) -> ShardLayout:
    """The host part of the reference's ``_shard_layout``: window
    boundaries hitting equal block-count targets (``searchsorted`` on
    ``block_starts``), then the counts and the reassembly index.  A pure
    function of (ragged stream, n_dev)."""
    l, W, t_blk = ragged.l, ragged.num_windows, ragged.num_blocks
    block_starts = ragged.block_starts.cpu().numpy().astype(np.int64)
    targets = (np.arange(1, n_dev) * t_blk) // n_dev
    w_bound = np.concatenate(
        [[0], np.searchsorted(block_starts, targets, side="left"), [W]]
    )
    w_bound = np.maximum.accumulate(np.minimum(w_bound, W))
    w_cnt = np.diff(w_bound)
    b_cnt = block_starts[w_bound[1:]] - block_starts[w_bound[:-1]]
    b_max = max(int(b_cnt.max()) if n_dev else 1, 1)
    w_max = max(int(w_cnt.max()) if n_dev else 1, 1)
    idx = np.concatenate(
        [d * w_max * l + np.arange(w_cnt[d] * l) for d in range(n_dev)]
    ) if W else np.zeros(0, np.int64)
    return ShardLayout(w_bound, w_cnt, b_cnt, b_max, w_max, torch.from_numpy(idx))


def rank_artifact(ragged: RaggedSchedule, layout: ShardLayout,
                  rank: int) -> Optional[RaggedSchedule]:
    """Rank ``rank``'s window range of ``ragged`` as a ragged stream of its
    own, on the stream's device (its leaves are row ranges of the whole
    stream's): ``block_starts`` rebased to the range's first block,
    ``block_window`` to its first window, the identity row order over
    ``w_cnt * l`` rows.  None for a rank that owns no window."""
    w0, w1 = int(layout.w_bound[rank]), int(layout.w_bound[rank + 1])
    if w1 == w0:
        return None
    bs = ragged.block_starts
    g0, g1 = int(bs[w0]), int(bs[w1])
    cb, l = ragged.c_blk, ragged.l
    rows = slice(g0 * cb, g1 * cb)
    return RaggedSchedule(
        m_blk=ragged.m_blk[rows],
        col_blk=ragged.col_blk[rows],
        row_blk=ragged.row_blk[rows],
        row_perm=torch.arange((w1 - w0) * l, dtype=ragged.row_perm.dtype,
                              device=ragged.device),
        seg_blk=ragged.seg_blk[g0:g1],
        col_loc=ragged.col_loc[rows],
        block_window=ragged.block_window[g0:g1] - w0,
        block_starts=bs[w0:w1 + 1] - g0,
        l=l,
        num_windows=w1 - w0,
        c_blk=cb,
        num_blocks=g1 - g0,
        shape=((w1 - w0) * l, ragged.shape[1]),
        fusable=ragged.fusable,
        s_blk=ragged.s_blk,
        identity_perm=True,
        scale_blk=None if ragged.scale_blk is None else ragged.scale_blk[g0:g1],
    )


# ---------------------------------------------------------------------------
# Incremental re-planning for drifting sparsity: diff per-window content,
# recolor only dirty windows, splice their blocks into the existing stream.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RescheduleResult:
    """What one :func:`reschedule` delta did.  ``full_fallback``: the plan
    was rebuilt from scratch (load-balanced config, or nothing to diff
    against); ``spliced``: the ragged stream was updated in place through
    :func:`~repro_torch.core.packing.splice_ragged_blocks`."""

    windows: int
    dirty_windows: int
    reused_windows: int
    recolored_edges: int
    full_fallback: bool
    spliced: bool

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def reschedule(
    base: GustPlan,
    matrix: Union[np.ndarray, torch.Tensor, COOMatrix],
    *,
    workers: Optional[int] = None,
    store=None,
) -> GustPlan:
    """Re-plan ``matrix`` incrementally against ``base`` (a plan over the
    previous version of the same-shaped matrix), on ``base``'s device.

    Per-window content fingerprints are diffed; only dirty windows are
    recolored, and when ``base`` holds a materialized ragged artifact
    only their blocks are packed, every clean window's blocks copied on
    the device.  The result is bit for bit ``plan(matrix, base.config)``
    built fresh.  Incremental reuse needs ``load_balance=False`` (row
    balancing is a function of the whole matrix); a load-balanced config
    builds a fresh plan and says so in ``.resched.full_fallback``.  The
    returned plan carries its fingerprints for the next delta; window
    totals accumulate in ``sched_counters``."""
    from .scheduler import incremental_schedule, sched_counters

    if not isinstance(base, GustPlan):
        raise TypeError(f"reschedule() needs a GustPlan, got {type(base).__name__}")
    if base.sched is None:
        raise ValueError(
            "reschedule() needs the base plan's schedule; store-loaded/"
            "spec plans carry only the packed artifact — build fresh"
        )
    matrix = _as_coo(matrix, "reschedule()")
    if tuple(matrix.shape) != tuple(base.shape):
        raise ValueError(
            f"reschedule() cannot change the matrix shape "
            f"({tuple(base.shape)} -> {tuple(matrix.shape)}); build a fresh plan"
        )

    cfg = base.config
    W = base.sched.num_windows
    can_diff = base._window_hashes is not None or base._source is not None
    if cfg.load_balance or not can_diff:
        p = plan(matrix, cfg, cache=base.cache, store=store, workers=workers,
                 device=base.device)
        p.resched = RescheduleResult(
            windows=W, dirty_windows=W, reused_windows=0,
            recolored_edges=p.sched.nnz if p.sched is not None else 0,
            full_fallback=True, spliced=False,
        )
        return p

    edges_before = sched_counters["colored_edges"]
    new_sched, dirty, new_hashes = incremental_schedule(
        base.sched,
        matrix,
        old_coo=base._source,
        old_hashes=base._window_hashes,
        method=cfg.colorer,
        workers=workers,
    )
    recolored_edges = sched_counters["colored_edges"] - edges_before

    p = GustPlan(cfg, new_sched, cache=base.cache, device=base.device, source=matrix)
    p._window_hashes = new_hashes
    spliced = isinstance(base._artifact, RaggedSchedule) and p.layout == "ragged"
    if spliced:
        p._artifact = splice_ragged_blocks(
            base._artifact, new_sched, dirty,
            value_dtype=cfg.value_dtype, index_dtype=cfg.index_dtype,
        )
    if store is not None:
        p._store = store
        p._store_key = store.key(ScheduleCache.matrix_key(matrix), cfg)
        if spliced:
            p._store_put()  # the artifact is already there: write now
    p.resched = RescheduleResult(
        windows=W,
        dirty_windows=int(dirty.size),
        reused_windows=W - int(dirty.size),
        recolored_edges=int(recolored_edges),
        full_fallback=False,
        spliced=spliced,
    )
    return p
