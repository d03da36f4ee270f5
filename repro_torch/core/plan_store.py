"""PlanStore — persistent, content-keyed GUST plan artifacts.

Counterpart of ``repro.core.plan_store``: the same container, the same
:data:`FORMAT_VERSION`, the same :data:`ARTIFACT_KNOBS` and the same key,
so a file written by either package loads in the other bit for bit.
Leaves are torch tensors; bf16 leaves travel as their 16-bit patterns
(the header names ``bfloat16``), so no ``ml_dtypes`` is needed.

The paper's amortization story (§5.3) says the schedule is paid once per
matrix; :class:`~repro_torch.core.packing.ScheduleCache` enforces that within a
process, but every *new* server process still re-paid the edge coloring
at weight-load time.  The store extends the amortization across process
boundaries: ``plan(matrix, cfg, store=PlanStore(dir))`` reads a
previously packed artifact straight off disk (zero coloring work:
``sched_counters`` do not move) and writes one
back the first time a fresh plan materializes its pack.

Keying and versioning rules (ROADMAP §Scheduler + plan-store invariants):

* The key is ``sha1(matrix content hash | artifact-relevant config)``.
  Artifact-relevant means exactly the knobs that change the packed
  leaves/meta: ``l``, ``colorer``, ``load_balance``, ``c_blk``,
  ``layout``, ``waste_threshold``, ``value_dtype``, ``index_dtype``
  (:data:`ARTIFACT_KNOBS`).  Execution-time knobs (``backend``,
  ``gather``, ``pipeline``, ``interpret``, ``mesh_axis``) and the
  scheduler's ``workers`` count are **excluded** — the same artifact
  executes under any of them, bit-identically.
* Every file carries :data:`FORMAT_VERSION`; a version mismatch is a
  clean miss (counted in ``stale``), never an error — old files are
  simply re-written by the next warm-up.
* Writes are atomic **and durable** (``fsync`` of the same-directory
  temp file before ``os.replace``), so a crashed writer — or a host that
  loses power between write and rename — can leave a stray temp file
  but never a torn artifact at the final path.
* Loads are corruption-tolerant: *any* failure to parse (truncated file,
  bad magic, undecodable header, short array bytes) counts in
  ``corrupt`` and reads as a miss.
* Loads are I/O-fault-tolerant: transient ``OSError`` during the file
  read is retried with jittered exponential backoff
  (:func:`repro_torch.resilience.retrying`); exhausted retries count in
  ``io_errors`` and read as a miss — the caller re-packs fresh
  (``stored → fresh`` fallback), never raises on the serving path.
* Fault-injection sites (``store.get``, ``store.get.corrupt``,
  ``store.put``, ``store.put.crash`` — ROADMAP §Resilience invariants)
  are threaded through ``get``/``put``; with no ``FaultPlan`` installed
  each is a single module-global check.

File format (one plan per file, ``<key>.gustplan``)::

    magic "GUSTPLAN" | header_len uint64-LE | header JSON | raw leaf bytes

The header holds ``{format_version, meta, config, tuning, summary,
arrays: [{name, dtype, shape, offset, nbytes}]}``; leaf bytes follow
concatenated in ``arrays`` order.  A bespoke container instead of
``np.savez`` because the value leaves may be ``bfloat16``, which numpy's
own format can't round-trip.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..resilience import faults
from ..resilience.retry import retrying

__all__ = ["PlanStore", "ARTIFACT_KNOBS", "FORMAT_VERSION"]

FORMAT_VERSION = 1

_MAGIC = b"GUSTPLAN"

#: Header dtype name -> (numpy dtype of the raw bytes, torch dtype).
_DTYPES = {
    "float32": (np.float32, torch.float32),
    "bfloat16": (np.int16, torch.bfloat16),
    "int8": (np.int8, torch.int8),
    "int16": (np.int16, torch.int16),
    "int32": (np.int32, torch.int32),
    "int64": (np.int64, torch.int64),
}


def _leaf_bytes(leaf) -> Tuple[str, Tuple[int, ...], bytes]:
    """(dtype name, shape, raw bytes) of a tensor (or array) leaf."""
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return name, tuple(t.shape), t.numpy().tobytes()


def _leaf_from_bytes(raw: bytes, name: str, shape) -> torch.Tensor:
    """A CPU tensor of the stored dtype from its raw bytes."""
    np_dt, torch_dt = _DTYPES[name]
    arr = np.frombuffer(raw, dtype=np_dt).reshape(shape).copy()
    t = torch.from_numpy(arr)
    return t.view(torch_dt) if torch_dt == torch.bfloat16 else t

#: The PlanConfig fields that determine the packed artifact's content.
ARTIFACT_KNOBS = (
    "l",
    "colorer",
    "load_balance",
    "c_blk",
    "layout",
    "waste_threshold",
    "value_dtype",
    "index_dtype",
)


def _tuplify(x):
    """JSON round-trips tuples (and the nested ``shape``) as lists; meta
    tuples must come back as tuples to compare/splice cleanly."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


class PlanStore:
    """Directory-backed store of packed plan artifacts.

    Thread-compatible and multi-process safe for its intended use
    (read-mostly fleets): concurrent writers of the same key race
    benignly — both write identical bytes and the atomic rename keeps
    whichever lands last.

    Counters: ``hits`` / ``misses`` (surfaced on ``GustPlan.cost()`` as
    ``store_hits`` / ``store_misses``), ``writes``, ``corrupt``
    (unparseable files), ``stale`` (format-version mismatches; a subset
    of misses), ``io_errors`` (reads that exhausted their retry budget;
    also a subset of misses), ``io_retries`` (transient read attempts
    that were retried).

    ``verify="load"`` runs the static artifact verifier
    (:mod:`repro_torch.analysis.verify`) on every parsed record: an
    artifact that parses but breaks a ``GUST-Pxx`` contract counts in
    ``corrupt`` and reads as a miss, never served.  A crash inside the
    verifier itself is not counted as corrupt: the record is served.
    """

    def __init__(
        self,
        path: str,
        verify: str = "off",
        *,
        read_retries: int = 2,
        retry_base_s: float = 0.01,
        retry_budget_s: float = 2.0,
    ):
        if verify not in ("off", "load"):
            raise ValueError(f"verify must be 'off' or 'load', got {verify!r}")
        self.path = os.fspath(path)
        self.verify = verify
        self.read_retries = read_retries
        self.retry_base_s = retry_base_s
        self.retry_budget_s = retry_budget_s
        os.makedirs(self.path, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.corrupt = 0
        self.stale = 0
        self.io_errors = 0
        self.io_retries = 0

    # -- keying --------------------------------------------------------------

    @staticmethod
    def config_token(config) -> str:
        """Canonical JSON of the artifact-relevant config subset."""
        knobs = {k: getattr(config, k) for k in ARTIFACT_KNOBS}
        return json.dumps(knobs, sort_keys=True, separators=(",", ":"))

    @classmethod
    def key(cls, matrix_key: str, config) -> str:
        h = hashlib.sha1()
        h.update(f"gust-plan|v{FORMAT_VERSION}|".encode())
        h.update(matrix_key.encode())
        h.update(b"|")
        h.update(cls.config_token(config).encode())
        return h.hexdigest()

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.gustplan")

    # -- write ---------------------------------------------------------------

    def put(
        self,
        key: str,
        spec: Dict,
        *,
        tuning: Optional[Dict] = None,
        summary: Optional[Dict] = None,
    ) -> str:
        """Persist a ``GustPlan.to_spec()`` dict (plus optional JSON-able
        ``tuning`` / ``summary`` sidecars) under ``key``.  Atomic and
        durable: the temp file is fsync'd before the rename, so readers
        only ever see complete files — even across a crash mid-write,
        which leaves at most a stray ``.tmp.*`` file (cleaned up here),
        never a torn ``.gustplan``."""
        faults.trip("store.put", tag=key)
        arrays = []
        chunks = []
        offset = 0
        for name in sorted(spec["leaves"]):
            dtype, shape, raw = _leaf_bytes(spec["leaves"][name])
            arrays.append(
                {
                    "name": name,
                    "dtype": dtype,
                    "shape": list(shape),
                    "offset": offset,
                    "nbytes": len(raw),
                }
            )
            chunks.append(raw)
            offset += len(raw)
        header = json.dumps(
            {
                "format_version": FORMAT_VERSION,
                "meta": list(spec["meta"]),
                "config": spec.get("config"),
                "tuning": tuning,
                "summary": summary,
                "arrays": arrays,
            },
            sort_keys=True,
        ).encode()

        path = self._file(key)
        tmp = f"{path}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
        try:
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                f.write(len(header).to_bytes(8, "little"))
                f.write(header)
                for raw in chunks:
                    f.write(raw)
                # Simulated crash point: data written but not yet durable.
                # A real crash here must never surface a torn final file —
                # the fsync + rename ordering below guarantees it.
                faults.trip("store.put.crash", tag=key)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.writes += 1
        return path

    # -- read ----------------------------------------------------------------

    def get(self, key: str) -> Optional[Dict]:
        """Load the record stored under ``key``: ``{"spec": {leaves, meta,
        config}, "tuning", "summary"}`` — or None (miss) when absent,
        version-stale, or corrupt.  Leaves come back as CPU tensors at
        their exact stored dtypes (bfloat16 included)."""
        path = self._file(key)
        if not os.path.exists(path):
            self.misses += 1
            return None
        try:
            blob = self._read_blob(key, path)
        except Exception:
            # Transient I/O exhausted its backoff budget: a counted clean
            # miss — the caller re-packs fresh (stored -> fresh fallback).
            self.io_errors += 1
            self.misses += 1
            return None
        try:
            spec = faults.trip("store.get.corrupt", tag=key)
            if spec is not None and blob:
                # Deterministic header corruption (a payload flip could
                # parse silently): must land as a counted corrupt miss.
                torn = bytearray(blob)
                torn[0] ^= 0xFF
                blob = bytes(torn)
            if blob[: len(_MAGIC)] != _MAGIC:
                raise ValueError("bad magic")
            hlen_at = len(_MAGIC)
            hlen = int.from_bytes(blob[hlen_at : hlen_at + 8], "little")
            body_at = hlen_at + 8 + hlen
            header = json.loads(blob[hlen_at + 8 : body_at].decode())
            if header.get("format_version") != FORMAT_VERSION:
                self.stale += 1
                self.misses += 1
                return None
            leaves = {}
            for rec in header["arrays"]:
                start = body_at + rec["offset"]
                stop = start + rec["nbytes"]
                if stop > len(blob):
                    raise ValueError("truncated array bytes")
                leaves[rec["name"]] = _leaf_from_bytes(
                    blob[start:stop], rec["dtype"], rec["shape"]
                )
            spec = {
                "leaves": leaves,
                "meta": _tuplify(header["meta"]),
                "config": header.get("config"),
            }
        except Exception:
            self.corrupt += 1
            self.misses += 1
            return None
        if self.verify == "load":
            try:
                from ..analysis.verify import verify as _verify

                findings = _verify(leaves, spec["meta"])
            except Exception:
                findings = None  # verifier crash != corrupt artifact
            if findings:
                self.corrupt += 1
                self.misses += 1
                return None
        self.hits += 1
        return {
            "spec": spec,
            "tuning": header.get("tuning"),
            "summary": header.get("summary"),
        }

    def _read_blob(self, key: str, path: str) -> bytes:
        """Read the raw container bytes, retrying transient I/O errors
        with jittered exponential backoff (bounded by
        ``retry_budget_s``).  Each attempt passes through the
        ``store.get`` fault site, so an injected ``times=N`` OSError
        proves the first ``N`` attempts fail and the ``N+1``-th serves."""

        def attempt():
            faults.trip("store.get", tag=key)
            with open(path, "rb") as f:
                return f.read()

        def count_retry(_attempt, _err):
            self.io_retries += 1

        return retrying(
            attempt,
            max_retries=self.read_retries,
            retry_on=(OSError, faults.FaultError),
            on_retry=count_retry,
            base_delay=self.retry_base_s,
            max_elapsed=self.retry_budget_s,
            seed=0,
        )()

    # -- introspection -------------------------------------------------------

    def keys(self):
        """Stored keys, sorted."""
        return sorted(
            name[: -len(".gustplan")]
            for name in os.listdir(self.path)
            if name.endswith(".gustplan")
        )

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._file(key))

    def __len__(self) -> int:
        return sum(
            1 for name in os.listdir(self.path) if name.endswith(".gustplan")
        )

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "writes": self.writes,
            "corrupt": self.corrupt,
            "stale": self.stale,
            "io_errors": self.io_errors,
            "io_retries": self.io_retries,
            "entries": len(self),
        }

    def __repr__(self) -> str:
        return f"PlanStore({self.path!r}, entries={len(self)})"
