"""Artifact verifier — the packed format's contracts as executable
``GUST-Pxx`` rules.

Counterpart of ``repro.analysis.verify``, rule for rule and finding for
finding (rule, leaf, message, indices, count).  Every rule checks a
*machine-decidable* contract of the packed scheduled format (ROADMAP.md
invariant sections; each rule cites its section).  The verifier runs on
numpy host copies of the leaves — no kernel execution — so it can gate
artifact loads (``PlanStore`` verify-on-load), run before a kernel's
first launch (``GustPlan.verify()``), and scan store directories from
``python -m repro_torch.analysis verify``.

The port's leaves are torch tensors, possibly on the card: each leaf is
copied to the host once per :func:`verify` call (never once per rule).
numpy has no bfloat16 without ``ml_dtypes``, so a bf16 value leaf is
widened to float32 on the host (exact: zero stays zero) while the rules
that read dtypes see its own name, ``bfloat16``; index leaves keep their
int16/int32 dtypes.

Padding identification is the one subtle point.  A padding slot is
``(m=0, col=lane, row=0)`` by construction, but from leaves alone a
zero *value* does not always mean padding: an int8 stream's real edges
may quantize to 0 (``rint(v/scale)`` of a tiny value), keeping their
real column/row.  The rules therefore split by stream dtype:

* float streams: a zero-valued slot IS padding (real COO edges are
  nonzero), so canonicalization (GUST-P02/P03) checks every zero slot;
* int8 streams: canonicalization runs at block granularity — a block
  containing any real edge must contain a ``±127`` (``scale =
  absmax/127`` puts the absmax slot exactly there), so an all-zero
  block is provably all-padding and only those are canonicalized.

Real cycles form a per-window *prefix* of the stream (the packer
scatters window ``w``'s ``C_w`` real cycles to its leading rows), which
gives the sound padding-region rule GUST-P01: within a window, no
nonzero row (block, for int8) may follow an all-zero one.  That is what
catches a flipped padding value without knowing the source matrix.

Dependent rules gate on their prerequisites (e.g. the GUST-P10 remap
check only evaluates slots whose column is in-bounds and only when the
segment table itself verified) so one seeded corruption fires exactly
one rule.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["Finding", "verify", "verify_artifact", "RULES"]

#: Max offending indices carried per finding (evidence, not a full dump).
_MAX_INDICES = 8

#: rule id -> (severity, ROADMAP section, one-line contract).
RULES: Dict[str, Tuple[str, str, str]] = {
    "GUST-P01": ("error", "Packed-format invariants",
                 "real cycles are a per-window prefix: no nonzero row/block "
                 "after an all-zero one (padding value slots are 0)"),
    "GUST-P02": ("error", "Packed-format invariants",
                 "padding column slots hold their own lane index "
                 "(gather v[lane], in-bounds)"),
    "GUST-P03": ("error", "Packed-format invariants",
                 "padding row slots are 0; every row_blk is in [0, l)"),
    "GUST-P04": ("error", "Packed-format invariants",
                 "fusable lane structure: col % l in {lane, l-1-lane} "
                 "for every slot"),
    "GUST-P05": ("error", "Scheduler + plan-store invariants",
                 "index-dtype policy: col/row/col_loc share one int16/int32 "
                 "dtype; seg_blk is int32; block metadata is integral"),
    "GUST-P06": ("error", "Ragged-stream invariants",
                 "block_starts is a (W+1,) strictly increasing prefix from "
                 "0 to num_blocks (>= 1 block per window)"),
    "GUST-P07": ("error", "Ragged-stream invariants",
                 "block_window is the sorted expansion of block_starts "
                 "(contiguous window ownership)"),
    "GUST-P08": ("error", "Gather-locality invariants",
                 "seg_blk rows are sorted: strictly increasing distinct "
                 "segments then segment-0 padding"),
    "GUST-P09": ("error", "Gather-locality invariants",
                 "seg_blk entries are in-bounds: 0 <= seg < seg_count"),
    "GUST-P10": ("error", "Gather-locality invariants",
                 "col_loc remap: col_loc % l == col % l and "
                 "seg_blk[t, col_loc // l] == col // l for every slot"),
    "GUST-P11": ("error", "Kernel-speed invariants",
                 "scale_blk is (T_blk,) float32, finite and > 0"),
    "GUST-P12": ("error", "Kernel-speed invariants",
                 "all-zero (padding) blocks carry scale exactly 1.0"),
    "GUST-P13": ("error", "Kernel-speed invariants",
                 "an int8 block with any nonzero payload holds a +/-127 "
                 "(scale = absmax/127 pins the absmax slot there)"),
    "GUST-P14": ("error", "Packed-format invariants",
                 "collision-freedom: within a stream row (one window cycle) "
                 "no two real slots share an adder (row_blk)"),
    "GUST-P15": ("error", "Packed-format invariants",
                 "leaf/meta consistency: stream shapes match the meta "
                 "geometry and row_perm is a (identity-when-flagged) "
                 "permutation of the scheduled rows"),
    "GUST-P16": ("error", "SpGEMM invariants",
                 "canonical COO: strictly increasing row*n+col keys, "
                 "in-bounds indices, no explicit zeros"),
    "GUST-P17": ("error", "Gather-locality invariants",
                 "every col_blk is in [0, seg_count*l): the padded-x gather "
                 "stays in-bounds"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified-contract violation.

    ``rule`` is the ``GUST-Pxx`` id (see :data:`RULES` and the matching
    ROADMAP.md anchor), ``leaf`` the offending array leaf (or pseudo-leaf
    like ``"meta"``), ``indices`` up to ``_MAX_INDICES`` offending
    positions as index tuples, ``count`` the total violation count.
    """

    rule: str
    severity: str
    leaf: str
    message: str
    indices: Tuple[Tuple[int, ...], ...] = ()
    count: int = 0
    section: str = ""

    def __str__(self) -> str:
        where = f" at {list(self.indices)}" if self.indices else ""
        more = (
            f" (+{self.count - len(self.indices)} more)"
            if self.count > len(self.indices)
            else ""
        )
        return (
            f"[{self.rule}:{self.severity}] {self.leaf}: {self.message}"
            f"{where}{more}"
        )


def _finding(rule: str, leaf: str, message: str,
             where: Optional[np.ndarray] = None) -> Finding:
    severity, section, _ = RULES[rule]
    indices: Tuple[Tuple[int, ...], ...] = ()
    count = 0
    if where is not None:
        idx = np.argwhere(where)
        count = int(idx.shape[0])
        indices = tuple(tuple(int(v) for v in row) for row in idx[:_MAX_INDICES])
    return Finding(rule=rule, severity=severity, leaf=leaf, message=message,
                   indices=indices, count=count, section=section)


# ---------------------------------------------------------------------------
# Input normalization.
# ---------------------------------------------------------------------------


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A numpy host copy of one leaf (torch tensor, numpy array or list)
    and its dtype's name.  Float dtypes numpy cannot hold (bfloat16) are
    widened to float32, exactly; the name stays the leaf's own."""
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.is_floating_point() and name not in ("float16", "float32", "float64"):
            t = t.float()
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name == "bfloat16":  # ml_dtypes' bfloat16
        arr = arr.astype(np.float32)
    return arr, name


def _normalize(plan_or_leaves, meta) -> Tuple[Dict[str, np.ndarray], Tuple,
                                              Dict[str, str]]:
    """Coerce any accepted input to ``(leaves dict of numpy arrays, meta,
    leaf dtype names)``.

    Accepts a ``GustPlan`` (packs lazily via ``.artifact``), a
    ``PackedSchedule`` / ``RaggedSchedule`` (duck-typed on
    ``block_starts``), or an explicit ``(leaves, meta)`` pair in the
    plan-store/codec wire format (torch or numpy leaves).  Only duck
    typing — no ``repro_torch.core`` import.
    """
    obj = plan_or_leaves
    if hasattr(obj, "artifact") and hasattr(obj, "config"):  # GustPlan
        obj = obj.artifact
    if hasattr(obj, "m_blk"):  # PackedSchedule / RaggedSchedule
        leaves = {
            "m_blk": obj.m_blk, "col_blk": obj.col_blk,
            "row_blk": obj.row_blk, "row_perm": obj.row_perm,
            "seg_blk": obj.seg_blk, "col_loc": obj.col_loc,
        }
        if getattr(obj, "scale_blk", None) is not None:
            leaves["scale_blk"] = obj.scale_blk
        if hasattr(obj, "block_starts"):
            leaves["block_window"] = obj.block_window
            leaves["block_starts"] = obj.block_starts
            meta = ("ragged", obj.l, obj.num_windows, obj.c_blk,
                    obj.num_blocks, obj.shape, obj.fusable, obj.s_blk,
                    obj.identity_perm)
        else:
            meta = (obj.l, obj.num_windows, obj.c_pad, obj.shape,
                    obj.fusable, obj.c_blk, obj.s_blk, obj.identity_perm)
    elif isinstance(obj, dict):
        leaves = obj
        if meta is None:
            raise ValueError("verify(leaves_dict, meta): meta is required")
    else:
        raise TypeError(
            "verify() takes a GustPlan, a packed/ragged artifact, a "
            f"(leaves, meta) pair, or a COOMatrix; got {type(obj).__name__}"
        )
    host = {k: _host(v) for k, v in leaves.items()}
    return ({k: a for k, (a, _) in host.items()}, tuple(meta),
            {k: name for k, (_, name) in host.items()})


@dataclasses.dataclass
class _Geometry:
    """Meta tuple decoded to one namespace for both layouts."""

    ragged: bool
    l: int
    num_windows: int
    c_blk: int
    shape: Tuple[int, int]
    fusable: bool
    s_blk: int
    identity_perm: bool
    c_pad: int = 0        # padded layout only
    num_blocks: int = 0   # ragged layout only

    @property
    def seg_count(self) -> int:
        return -(-self.shape[1] // self.l)

    @property
    def stream_rows(self) -> int:
        if self.ragged:
            return self.num_blocks * self.c_blk
        return self.num_windows * self.c_pad


def _decode_meta(meta: Tuple) -> _Geometry:
    if meta and meta[0] == "ragged":
        _, l, w, c_blk, t_blk, shape, fusable, s_blk, identity_perm = meta
        return _Geometry(True, int(l), int(w), int(c_blk), tuple(shape),
                         bool(fusable), int(s_blk), bool(identity_perm),
                         num_blocks=int(t_blk))
    l, w, c_pad, shape, fusable, c_blk, s_blk, identity_perm = meta
    return _Geometry(False, int(l), int(w), int(c_blk), tuple(shape),
                     bool(fusable), int(s_blk), bool(identity_perm),
                     c_pad=int(c_pad))


# ---------------------------------------------------------------------------
# Rule implementations.  Each returns a list of findings; dependent rules
# receive the prerequisite verdicts so one corruption fires one rule.
# ---------------------------------------------------------------------------


def _window_of_rows(g: _Geometry,
                    leaves: Dict[str, np.ndarray]) -> np.ndarray:
    """Window id of every stream row (int64), from the layout geometry."""
    rows = np.arange(g.stream_rows, dtype=np.int64)
    if not g.ragged:
        return rows // max(g.c_pad, 1)
    bw = np.asarray(leaves["block_window"], np.int64)
    return bw[np.minimum(rows // g.c_blk, max(bw.shape[0] - 1, 0))]


def _check_meta_shapes(leaves, g: _Geometry, names) -> List[Finding]:
    out: List[Finding] = []
    rows = g.stream_rows
    for name in ("m_blk", "col_blk", "row_blk", "col_loc"):
        arr = leaves.get(name)
        if arr is None:
            out.append(_finding("GUST-P15", name, "leaf missing"))
        elif arr.shape != (rows, g.l):
            out.append(_finding(
                "GUST-P15", name,
                f"shape {arr.shape} != stream geometry ({rows}, {g.l})",
            ))
    if not g.ragged and g.c_pad % max(g.c_blk, 1):
        out.append(_finding(
            "GUST-P15", "meta",
            f"c_pad {g.c_pad} not a multiple of c_blk {g.c_blk}",
        ))
    vdt = names.get("m_blk")
    if vdt is not None and vdt not in ("float32", "bfloat16", "int8"):
        out.append(_finding(
            "GUST-P15", "m_blk", f"unsupported value dtype {vdt}"))
    quant = vdt == "int8"
    if quant and "scale_blk" not in leaves:
        out.append(_finding(
            "GUST-P15", "scale_blk", "int8 stream without a scale leaf"))
    if not quant and "scale_blk" in leaves:
        out.append(_finding(
            "GUST-P15", "scale_blk",
            f"scale leaf on a non-quantized ({vdt}) stream"))
    perm = leaves.get("row_perm")
    if perm is not None:
        wl = g.num_windows * g.l
        if perm.shape != (wl,):
            out.append(_finding(
                "GUST-P15", "row_perm",
                f"shape {perm.shape} != ({wl},)"))
        elif g.identity_perm:
            if not np.array_equal(perm, np.arange(wl, dtype=perm.dtype)):
                out.append(_finding(
                    "GUST-P15", "row_perm",
                    "identity_perm is set but row_perm is not the identity",
                    np.asarray(perm) != np.arange(wl),
                ))
        elif not np.array_equal(np.sort(np.asarray(perm, np.int64)),
                                np.arange(wl, dtype=np.int64)):
            out.append(_finding(
                "GUST-P15", "row_perm",
                f"not a permutation of arange({wl})"))
    return out


def _check_dtypes(leaves, g: _Geometry, names) -> List[Finding]:
    out: List[Finding] = []
    idx_dtypes = {names[k] for k in ("col_blk", "row_blk", "col_loc") if k in leaves}
    if not idx_dtypes <= {"int16", "int32"}:
        out.append(_finding(
            "GUST-P05", "col_blk",
            f"index dtypes {sorted(idx_dtypes)} outside the int16/int32 "
            "policy"))
    elif len(idx_dtypes) > 1:
        out.append(_finding(
            "GUST-P05", "col_blk",
            f"col/row/col_loc dtypes disagree: {sorted(idx_dtypes)}"))
    if "seg_blk" in leaves and names["seg_blk"] != "int32":
        out.append(_finding(
            "GUST-P05", "seg_blk",
            f"seg_blk is {names['seg_blk']}, contract says "
            "int32"))
    for name in ("block_window", "block_starts", "row_perm"):
        arr = leaves.get(name)
        if arr is not None and not np.issubdtype(arr.dtype, np.integer):
            out.append(_finding(
                "GUST-P05", name, f"non-integral dtype {names[name]}"))
    return out


def _check_ragged_meta(leaves, g: _Geometry) -> List[Finding]:
    out: List[Finding] = []
    bs = leaves.get("block_starts")
    bw = leaves.get("block_window")
    if bs is None or bw is None:
        return [_finding("GUST-P06", "block_starts",
                         "ragged artifact missing block metadata leaves")]
    bs = np.asarray(bs, np.int64)
    ok = True
    if bs.shape != (g.num_windows + 1,):
        out.append(_finding(
            "GUST-P06", "block_starts",
            f"shape {bs.shape} != (num_windows+1,) = ({g.num_windows + 1},)"))
        ok = False
    else:
        if bs[0] != 0 or bs[-1] != g.num_blocks:
            out.append(_finding(
                "GUST-P06", "block_starts",
                f"prefix runs {bs[0]}..{bs[-1]}, expected 0..{g.num_blocks}"))
            ok = False
        bad = np.diff(bs) < 1
        if bad.any():
            out.append(_finding(
                "GUST-P06", "block_starts",
                "not strictly increasing (every window owns >= 1 block)",
                bad))
            ok = False
    if ok:
        expect = np.repeat(np.arange(g.num_windows, dtype=np.int64),
                           np.diff(bs))
        bw64 = np.asarray(bw, np.int64)
        if bw64.shape != expect.shape:
            out.append(_finding(
                "GUST-P07", "block_window",
                f"shape {bw64.shape} != (num_blocks,) = {expect.shape}"))
        elif not np.array_equal(bw64, expect):
            out.append(_finding(
                "GUST-P07", "block_window",
                "not the sorted expansion of block_starts (window block "
                "ownership must be contiguous)", bw64 != expect))
    return out


def _padding_masks(leaves, g: _Geometry):
    """(zero_slots, padding_slots, pad_rows, row_zero, window_of_row).

    ``padding_slots`` is the *provable* padding region: every zero slot
    for float streams; for int8 streams only slots in all-zero blocks
    (a block holding any real edge provably holds a +/-127, GUST-P13).
    """
    m = leaves["m_blk"]
    zero = m == 0  # a bf16 leaf arrives widened to f32: zero stays zero
    row_zero = zero.all(axis=1)
    win = _window_of_rows(g, leaves)
    if m.dtype == np.int8:
        t_blk = zero.shape[0] // max(g.c_blk, 1)
        blk_zero = zero[: t_blk * g.c_blk].reshape(t_blk, -1).all(axis=1)
        padding = np.repeat(blk_zero, g.c_blk)[:, None] & zero
    else:
        padding = zero
    return zero, padding, row_zero, win


def _check_padding_prefix(leaves, g: _Geometry, zero, row_zero,
                          win) -> List[Finding]:
    """GUST-P01: within each window nonzero content never follows an
    all-zero row (float) / block (int8)."""
    m = leaves["m_blk"]
    if m.dtype == np.int8:
        t_blk = zero.shape[0] // max(g.c_blk, 1)
        unit_zero = zero[: t_blk * g.c_blk].reshape(t_blk, -1).all(axis=1)
        unit_win = win[:: g.c_blk][:t_blk]
    else:
        unit_zero = row_zero
        unit_win = win
    n_units = unit_zero.shape[0]
    if n_units == 0:
        return []
    # "saw an all-zero unit earlier in my window": units are already
    # window-contiguous, so it's a prefix-count difference.
    first = np.ones(n_units, dtype=bool)
    first[1:] = unit_win[1:] != unit_win[:-1]
    idx = np.arange(n_units)
    start = np.maximum.accumulate(np.where(first, idx, 0))
    cs = np.cumsum(unit_zero)
    zeros_before = (cs - unit_zero) - (cs[start] - unit_zero[start])
    bad = (~unit_zero) & (zeros_before > 0)
    if not bad.any():
        return []
    unit = "block" if m.dtype == np.int8 else "row"
    return [_finding(
        "GUST-P01", "m_blk",
        f"nonzero stream {unit} follows an all-zero {unit} in the same "
        f"window (real cycles must be a prefix; padding values must be 0)",
        bad)]


def _check_padding_canonical(leaves, g: _Geometry, padding) -> List[Finding]:
    out: List[Finding] = []
    lane = np.arange(g.l, dtype=np.int64)
    col = np.asarray(leaves["col_blk"], np.int64)
    row = np.asarray(leaves["row_blk"], np.int64)
    bad_col = padding & (col != lane[None, :])
    if bad_col.any():
        out.append(_finding(
            "GUST-P02", "col_blk",
            "padding slot column != its lane index (padding must gather "
            "v[lane])", bad_col))
    bad_row = padding & (row != 0)
    if bad_row.any():
        out.append(_finding(
            "GUST-P03", "row_blk",
            "padding slot row != 0", bad_row))
    oob_row = (row < 0) | (row >= g.l)
    if oob_row.any():
        out.append(_finding(
            "GUST-P03", "row_blk",
            f"row_blk outside [0, l={g.l})", oob_row))
    return out


def _check_col_bounds(leaves, g: _Geometry) -> List[Finding]:
    col = np.asarray(leaves["col_blk"], np.int64)
    hi = g.seg_count * g.l
    oob = (col < 0) | (col >= hi)
    if not oob.any():
        return []
    return [_finding(
        "GUST-P17", "col_blk",
        f"column outside the padded gather range [0, seg_count*l={hi})",
        oob)]


def _check_fusable(leaves, g: _Geometry) -> List[Finding]:
    if not g.fusable:
        return []
    lane = np.arange(g.l, dtype=np.int64)
    off = np.asarray(leaves["col_blk"], np.int64) % g.l
    bad = (off != lane[None, :]) & (off != (g.l - 1 - lane)[None, :])
    if not bad.any():
        return []
    return [_finding(
        "GUST-P04", "col_blk",
        "fusable flag set but col % l is neither lane nor l-1-lane",
        bad)]


def _check_gather_tables(leaves, g: _Geometry,
                         col_ok: bool) -> List[Finding]:
    out: List[Finding] = []
    seg = leaves.get("seg_blk")
    if seg is None:
        return [_finding("GUST-P09", "seg_blk", "gather table leaf missing")]
    seg = np.asarray(seg, np.int64)
    rows = leaves["m_blk"].shape[0]
    t_blk = -(-rows // max(g.c_blk, 1))
    if seg.shape != (t_blk, g.s_blk):
        return [_finding(
            "GUST-P09", "seg_blk",
            f"shape {seg.shape} != (T_blk, S_blk) = ({t_blk}, {g.s_blk})")]
    oob = (seg < 0) | (seg >= g.seg_count)
    seg_ok = True
    if oob.any():
        out.append(_finding(
            "GUST-P09", "seg_blk",
            f"segment id outside [0, seg_count={g.seg_count})", oob))
        seg_ok = False
    # Sorted structure: a strictly increasing distinct prefix, then 0
    # padding.  0 can only legitimately appear at slot 0, so any later
    # entry must be 0 (padding) or > its predecessor.
    if g.s_blk > 1:
        nxt, prev = seg[:, 1:], seg[:, :-1]
        bad = ~((nxt == 0) | (nxt > prev))
        if bad.any():
            idx = np.zeros_like(seg, dtype=bool)
            idx[:, 1:] = bad
            out.append(_finding(
                "GUST-P08", "seg_blk",
                "row not sorted (distinct ascending segments then "
                "segment-0 padding)", idx))
            seg_ok = False
    # Remap consistency — gated on the table itself and on in-bounds
    # columns so a GUST-P08/P09/P17 corruption doesn't double-fire here.
    if seg_ok and col_ok:
        col = np.asarray(leaves["col_blk"], np.int64)
        loc = np.asarray(leaves["col_loc"], np.int64)
        if loc.shape != col.shape:
            return out + [_finding(
                "GUST-P10", "col_loc",
                f"shape {loc.shape} != col_blk shape {col.shape}")]
        bad_lane = (loc % g.l) != (col % g.l)
        lseg = loc // g.l
        bad_slot = (lseg < 0) | (lseg >= g.s_blk)
        t_of_row = np.minimum(
            np.arange(col.shape[0]) // max(g.c_blk, 1), t_blk - 1
        )
        lookup = seg[t_of_row[:, None],
                     np.clip(lseg, 0, g.s_blk - 1)]
        bad_seg = lookup != (col // g.l)
        bad = bad_lane | bad_slot | bad_seg
        if bad.any():
            out.append(_finding(
                "GUST-P10", "col_loc",
                "local remap broken: need col_loc % l == col % l and "
                "seg_blk[t, col_loc // l] == col // l", bad))
    return out


def _check_scales(leaves, g: _Geometry, zero, names) -> List[Finding]:
    m = leaves["m_blk"]
    if m.dtype != np.int8:
        return []
    out: List[Finding] = []
    scale = leaves.get("scale_blk")
    if scale is None:
        return []  # GUST-P15 already reported the missing leaf
    rows = m.shape[0]
    t_blk = rows // max(g.c_blk, 1)
    if scale.shape != (t_blk,) or names["scale_blk"] != "float32":
        return [_finding(
            "GUST-P11", "scale_blk",
            f"expected (T_blk,)=({t_blk},) float32, got {scale.shape} "
            f"{names['scale_blk']}")]
    s = np.asarray(scale, np.float64)
    bad = ~np.isfinite(s) | (s <= 0)
    if bad.any():
        out.append(_finding(
            "GUST-P11", "scale_blk", "scale not finite-positive", bad))
        return out
    blk_zero = zero[: t_blk * g.c_blk].reshape(t_blk, -1).all(axis=1)
    bad_pad = blk_zero & (s != 1.0)
    if bad_pad.any():
        out.append(_finding(
            "GUST-P12", "scale_blk",
            "all-zero (padding) block scale != 1.0", bad_pad))
    q = np.asarray(m[: t_blk * g.c_blk], np.int64).reshape(t_blk, -1)
    bad_peak = (~blk_zero) & (np.abs(q).max(axis=1) != 127)
    if bad_peak.any():
        out.append(_finding(
            "GUST-P13", "m_blk",
            "block with nonzero payload lacks a +/-127 (absmax/127 "
            "quantization pins the absmax slot at +/-127)", bad_peak))
    return out


def _check_collisions(leaves, g: _Geometry, zero) -> List[Finding]:
    """GUST-P14: within a stream row, real slots route to distinct
    adders.  Lane exclusivity is structural in the packed layout; adder
    (row) exclusivity is the paper's collision-freedom."""
    row = np.asarray(leaves["row_blk"], np.int64)
    real = ~zero
    if not real.any():
        return []
    # bucket-count per (stream row, adder) with values clipped in-range
    # (out-of-range already fires GUST-P03)
    r = np.clip(row, 0, g.l - 1)
    rows = row.shape[0]
    keys = np.arange(rows, dtype=np.int64)[:, None] * g.l + r
    counts = np.bincount(keys[real].ravel(), minlength=rows * g.l)
    dup_key = counts > 1
    if not dup_key.any():
        return []
    bad = real & dup_key.reshape(rows, g.l)[
        np.arange(rows)[:, None], r]
    return [_finding(
        "GUST-P14", "row_blk",
        "two real slots of one cycle share an adder (colors must be "
        "collision-free within a window)", bad)]


def _verify_coo(coo) -> List[Finding]:
    """GUST-P16: canonical sparse COO (the SpGEMM output contract)."""
    out: List[Finding] = []
    m, n = coo.shape
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    vals = np.asarray(coo.vals)
    oob = (rows < 0) | (rows >= m) | (cols < 0) | (cols >= n)
    if oob.any():
        out.append(_finding(
            "GUST-P16", "rows/cols",
            f"index outside {coo.shape}", oob))
        return out
    keys = rows * n + cols
    if keys.shape[0] > 1:
        bad = keys[1:] <= keys[:-1]
        if bad.any():
            idx = np.zeros_like(keys, dtype=bool)
            idx[1:] = bad
            out.append(_finding(
                "GUST-P16", "rows/cols",
                "row*n+col keys not strictly increasing (canonical COO is "
                "deduplicated and row-major sorted)", idx))
    zero = vals == 0
    if zero.any():
        out.append(_finding(
            "GUST-P16", "vals", "explicit zeros in a canonical COO", zero))
    return out


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------


def verify(plan_or_leaves, meta: Optional[Sequence] = None) -> List[Finding]:
    """Verify a packed GUST artifact against every ``GUST-Pxx`` rule.

    ``plan_or_leaves`` may be a ``GustPlan`` (its artifact is packed
    lazily), a ``PackedSchedule`` / ``RaggedSchedule``, a ``COOMatrix``
    (canonical-form check, GUST-P16), or a leaves dict with ``meta`` the
    codec meta tuple.  Returns a list of :class:`Finding` — empty means
    every machine-checkable contract holds.
    """
    if (hasattr(plan_or_leaves, "rows") and hasattr(plan_or_leaves, "vals")
            and not hasattr(plan_or_leaves, "m_blk")):
        return _verify_coo(plan_or_leaves)
    leaves, meta, names = _normalize(plan_or_leaves, meta)
    g = _decode_meta(meta)

    findings = _check_meta_shapes(leaves, g, names)
    core = ("m_blk", "col_blk", "row_blk", "col_loc")
    if any(f.leaf in core and f.rule == "GUST-P15" for f in findings):
        return findings  # geometry broken: element rules would misindex
    findings += _check_dtypes(leaves, g, names)
    if g.ragged:
        ragged_findings = _check_ragged_meta(leaves, g)
        findings += ragged_findings
        if any(f.rule == "GUST-P06" for f in ragged_findings):
            return findings  # window mapping unusable downstream

    zero, padding, row_zero, win = _padding_masks(leaves, g)
    findings += _check_padding_prefix(leaves, g, zero, row_zero, win)
    findings += _check_padding_canonical(leaves, g, padding)
    col_findings = _check_col_bounds(leaves, g)
    findings += col_findings
    findings += _check_fusable(leaves, g)
    findings += _check_gather_tables(leaves, g, col_ok=not col_findings)
    findings += _check_scales(leaves, g, zero, names)
    findings += _check_collisions(leaves, g, zero)
    return findings


#: Back-compat spelling used by the CLI and PlanStore hook.
verify_artifact = verify
