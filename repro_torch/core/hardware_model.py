"""Energy / bandwidth / resource model (paper §4, Tables 2 & 5).

Counterpart of ``repro.core.hardware_model``, copied as it is (numpy over
``formats``).  These are the paper's FPGA models — its clocks, powers
and energies — never numbers of the card the port runs on.

Energy constants for 32-bit quantities, in pJ [Dally '21/'22, as cited]:
  off-chip read 64 / on-chip read 11.84 / off-chip write 64 / on-chip
  write 16 / FP mult or accumulate 10 / movement 160 (off-chip) and 0.95
  (on-chip) per mm.  Distances: 5 mm off-chip<->on-chip, 1 mm between 1D
  neighbours, 129 mm average across the GUST crossbar.

Dynamic power (FPGA synthesis, Table 2): 1D-256 35.3 W, GUST-256 56.9 W,
GUST-87 16.8 W, GUST-8 3.4 W; Serpens 46.2 W.  Clocks: GUST/1D 96 MHz,
Serpens 223 MHz.

Bandwidth (§3.3): a length-l GUST streams (32+32+log2 l)·l + 1 bits per
cycle (matrix values, vector values, row indices, dump) — 18 433 bits for
l = 256, i.e. 224 GB/s at 96 MHz, matching the paper.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .formats import COOMatrix, GustSchedule

__all__ = [
    "EnergyConstants",
    "HardwareSpec",
    "GUST_256",
    "GUST_87",
    "GUST_8",
    "SYSTOLIC_1D_256",
    "SERPENS",
    "gust_energy_joules",
    "systolic_1d_energy_joules",
    "required_bandwidth_bits_per_s",
    "execution_seconds",
]


@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    """pJ per 32-bit quantity."""

    read_off: float = 64.0
    read_on: float = 11.84
    write_off: float = 64.0
    write_on: float = 16.0
    flop: float = 10.0  # FP multiply or accumulate
    move_off_per_mm: float = 160.0
    move_on_per_mm: float = 0.95
    dist_off_mm: float = 5.0
    dist_1d_mm: float = 1.0
    dist_gust_mm: float = 129.0  # average crossbar traversal


PJ = 1e-12
DEFAULT_ENERGY = EnergyConstants()


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    length: int
    freq_hz: float
    dynamic_power_w: float
    registers: int
    luts: int
    dsps: int

    @property
    def max_bandwidth_bits_per_s(self) -> float:
        return required_bandwidth_bits_per_s(self.length, self.freq_hz)


def required_bandwidth_bits_per_s(l: int, freq_hz: float = 96e6) -> float:
    """§3.3: (32 matrix + 32 vector + log2(l) row-index) bits per lane plus
    the dump wire, per cycle."""
    row_bits = max(int(np.ceil(np.log2(max(l, 2)))), 1)
    return ((64 + row_bits) * l + 1) * freq_hz


GUST_256 = HardwareSpec("gust-256", 256, 96e6, 56.9, 16_400, 888_000, 256)
GUST_87 = HardwareSpec("gust-87", 87, 96e6, 16.8, 5_600, 5_600, 174)
GUST_8 = HardwareSpec("gust-8", 8, 96e6, 3.4, 512, 5_000, 16)
SYSTOLIC_1D_256 = HardwareSpec("1d-256", 256, 96e6, 35.3, 8_200, 132_000, 256)
SERPENS = HardwareSpec("serpens", 256, 223e6, 46.2, 0, 0, 0)


def execution_seconds(cycles: float, spec: HardwareSpec) -> float:
    return cycles / spec.freq_hz


def gust_energy_joules(
    sched: GustSchedule,
    spec: HardwareSpec = GUST_256,
    consts: EnergyConstants = DEFAULT_ENERGY,
) -> float:
    """End-to-end SpMV energy for GUST (§4 accounting):

      * vector preload: n off-chip reads + moves + on-chip writes (the
        Buffer Filler stores the whole vector first), charged with device
        power over the transfer time;
      * scheduled stream: every slot (incl. padding — the stream is dense)
        moves value+col+row bits off-chip->on-chip, buffer write/read;
      * per real NZ: vector on-chip read, multiply, crossbar traversal,
        accumulate;
      * per output row: off-chip write;
      * dynamic power * execution time.
    """
    m, n = sched.shape
    l = spec.length
    c = consts
    slots = sched.total_colors * sched.l
    row_bits = max(int(np.ceil(np.log2(max(sched.l, 2)))), 1)
    words_per_slot = 1.0 + 1.0 + row_bits / 32.0  # value + col idx + row idx

    move_off = c.move_off_per_mm * c.dist_off_mm
    move_on = c.move_on_per_mm * c.dist_gust_mm

    vector_pj = n * (c.read_off + move_off + c.write_on)
    stream_pj = slots * words_per_slot * (c.read_off + move_off + c.write_on + c.read_on)
    compute_pj = sched.nnz * (c.read_on + c.flop + move_on + c.flop)
    output_pj = m * (c.write_off + move_off)

    exec_s = execution_seconds(sched.cycles, spec)
    preload_s = n / (spec.max_bandwidth_bits_per_s / 64.0)  # vector words
    power_j = spec.dynamic_power_w * (exec_s + preload_s)
    return (vector_pj + stream_pj + compute_pj + output_pj) * PJ + power_j


def systolic_1d_energy_joules(
    coo: COOMatrix,
    cycles: float,
    spec: HardwareSpec = SYSTOLIC_1D_256,
    consts: EnergyConstants = DEFAULT_ENERGY,
) -> float:
    """1D baseline: streams the *dense* m×n matrix (zeros included) plus the
    vector; neighbour-to-neighbour moves of 1 mm."""
    m, n = coo.shape
    c = consts
    move_off = c.move_off_per_mm * c.dist_off_mm
    move_on = c.move_on_per_mm * c.dist_1d_mm

    stream_pj = (m * n + n) * (c.read_off + move_off + c.write_on + c.read_on)
    compute_pj = coo.nnz * (2 * c.flop + move_on)
    # zeros still ripple through the array
    ripple_pj = (m * n - coo.nnz) * move_on
    output_pj = m * (c.write_off + move_off)

    power_j = spec.dynamic_power_w * execution_seconds(cycles, spec)
    return (stream_pj + compute_pj + ripple_pj + output_pj) * PJ + power_j
