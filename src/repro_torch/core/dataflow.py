"""Dataflow engine: loop orders, tiling schedules, and buffer-access counts.

Reproduces the paper's §2.1/Fig. 1 accounting and the §4 mapping (temporal
switches ``ts`` and temporal folds ``tf``) that the perf model consumes.

Counting convention (documented for the Fig. 1 table reproduction):
  * GEMM I(C x K) @ W(K x D) -> O(C x D), DPU has M DPEs of size N,
    F = ceil(K / N) temporal folds per output value.
  * accesses are counted at *element* granularity against the unified
    buffer, per the innermost loop that re-touches the operand:
      - OS (loops c, d, k): every (c, d) walks all of K for both I and W;
        O is written exactly once (psums never leave the DPU).
      - IS (loops c, k, d): I read once (C*K); W re-read for every c;
        psums for a given output are produced F times spread across
        non-consecutive cycles -> without BPCA each one is written and
        all re-read for reduction.
      - WS (loops k, d, c): W read once (K*D); I re-read for every d;
        psum traffic as IS.
  * with a BPCA, psum write/read traffic collapses to zero (in-situ analog
    accumulation) as long as the in-flight outputs fit the p=4608 capacitor
    bank; the excess fraction spills and is accounted like the non-BPCA
    case (core.perf_model handles the spill).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.types import BPCA_NUM_CAPACITORS, Dataflow


@dataclasses.dataclass(frozen=True)
class GemmShape:
    c: int
    k: int
    d: int

    @property
    def outputs(self) -> int:
        return self.c * self.d


@dataclasses.dataclass(frozen=True)
class BufferAccesses:
    """Element-granularity unified-buffer accesses for one GEMM."""
    input_reads: int
    weight_reads: int
    output_writes: int
    psum_writes: int
    psum_reads: int

    @property
    def total(self) -> int:
        return (self.input_reads + self.weight_reads + self.output_writes +
                self.psum_writes + self.psum_reads)


def buffer_accesses(g: GemmShape, dataflow: Dataflow, dpe_size: int,
                    with_bpca: bool) -> BufferAccesses:
    """Unified-buffer access counts for one GEMM under a dataflow."""
    f = max(1, math.ceil(g.k / dpe_size))
    if dataflow == Dataflow.OS:
        # OS walks K for every (c, d) pair.
        reads_i = g.c * g.d * g.k
        reads_w = g.c * g.d * g.k
        psw = psr = 0                      # accumulate in place (register/cap)
    elif dataflow == Dataflow.IS:
        reads_i = g.c * g.k                # inputs stationary: read once
        reads_w = g.c * g.k * g.d          # weights re-streamed per row
        psw = g.outputs * f
        psr = g.outputs * f                # write each psum + re-read to reduce
    else:  # WS
        reads_w = g.k * g.d                # weights stationary: read once
        reads_i = g.c * g.k * g.d          # inputs re-streamed per column
        psw = g.outputs * f
        psr = g.outputs * f
    if with_bpca:
        psw = psr = 0
    return BufferAccesses(reads_i, reads_w, g.outputs, psw, psr)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-GEMM DPU schedule counts for the event-driven perf model.

    cycles:          BPD integration cycles needed on one DPU
    weight_switches: number of times the DPU's weight operands change
    input_switches:  number of times the DPU's input operands change
    psum_events:     psums that leave the DPU (ADC + buffer round trip)
    adc_conversions: total ADC conversions
    inflight_outputs: outputs whose psums are concurrently parked (BPCA
                     capacitor pressure for IS/WS)
    """
    cycles: int
    weight_switches: int
    input_switches: int
    psum_events: int
    adc_conversions: int
    inflight_outputs: int


def schedule(g: GemmShape, dataflow: Dataflow, n: int, m: int,
             with_bpca: bool, os_speedup: int = 1) -> Schedule:
    """Schedule counts for one GEMM on a DPU with M DPEs of size N.

    ``os_speedup`` models HEANA's 10x coherent pulse accumulation in OS
    dataflow (TAOM pulses are 100 ps vs the BPD's 1 ns window) — folds for
    the *same* output value stream back-to-back into one integration
    window, so the fold loop runs up to 10x faster (paper §3.2.4).
    """
    f = max(1, math.ceil(g.k / n))
    work = g.c * g.d * f                    # (output, fold) pairs
    speed = os_speedup if dataflow == Dataflow.OS else 1
    cycles = math.ceil(work / (m * speed))

    d_tiles = math.ceil(g.d / m)
    if dataflow == Dataflow.OS:
        # per output tile: F folds, new weights AND inputs each fold
        weight_switches = g.c * d_tiles * f
        input_switches = g.c * d_tiles * f
        inflight = m                        # one tile of outputs in flight
    elif dataflow == Dataflow.IS:
        # inputs held per (row, fold); all D columns swept per hold
        weight_switches = g.c * f * d_tiles
        input_switches = g.c * f
        inflight = g.d                      # a whole output row in flight
    else:  # WS
        # weights held per (fold, d tile); all C rows swept per hold
        weight_switches = f * d_tiles
        input_switches = f * d_tiles * g.c
        inflight = g.c                      # a whole output column in flight
    if with_bpca:
        spill = max(0, inflight - BPCA_NUM_CAPACITORS) / max(inflight, 1)
        psum_events = int(g.outputs * (f - 1) * spill)
        adc = g.outputs + psum_events
    else:
        psum_events = g.outputs * (f - 1)   # every non-final fold round-trips
        adc = g.outputs * f
    return Schedule(cycles, weight_switches, input_switches, psum_events,
                    adc, inflight)


@dataclasses.dataclass(frozen=True)
class StreamCounts:
    """Operand stream volumes for the energy model (FIFO-reuse aware).

    ``dac_*``: DAC conversion events (one per operand value entering the
    analog domain; the *stationary* operand of a dataflow is sample-and-
    held, so it converts only when it actually changes).
    ``buf_*``: unified-buffer element fetches, with per-DPE FIFO replay of
    held operands (this is what Fig. 10's dedicated FIFOs buy; the
    pedagogical no-reuse counts live in ``buffer_accesses``).
    DPEs hold distinct output columns; inputs broadcast across DPEs.
    """
    dac_weight: int
    dac_input: int
    buf_weight: int
    buf_input: int


def stream_counts(g: GemmShape, dataflow: Dataflow, n: int, m: int
                  ) -> StreamCounts:
    f = max(1, math.ceil(g.k / n))
    kp = f * n                       # padded contraction length
    d_tiles = math.ceil(g.d / m)
    if dataflow == Dataflow.OS:
        # (d, c, k) order: weights replayed from FIFO across rows but
        # re-converted every fold; inputs re-streamed per column tile.
        dac_w = g.c * g.d * kp
        dac_i = g.c * kp * d_tiles
        buf_w = kp * g.d
        buf_i = g.c * kp * d_tiles
    elif dataflow == Dataflow.IS:
        # inputs sample-and-held per (row, fold); weights sweep columns.
        dac_w = g.c * g.d * kp
        dac_i = g.c * kp
        buf_w = g.c * g.d * kp       # weight working set too big for FIFOs
        buf_i = g.c * kp
    else:  # WS
        # weights sample-and-held per (fold, d tile); inputs stream.
        dac_w = kp * g.d
        dac_i = g.c * kp * d_tiles
        buf_w = kp * g.d
        buf_i = g.c * kp * d_tiles
    return StreamCounts(dac_w, dac_i, buf_w, buf_i)


def fig1_table(g: GemmShape, dpe_size: int = 83,
               with_bpca: bool = False) -> Dict[str, Dict[str, int]]:
    """The Fig. 1 comparison table: accesses per dataflow for one GEMM."""
    out = {}
    for df in (Dataflow.OS, Dataflow.IS, Dataflow.WS):
        acc = buffer_accesses(g, df, dpe_size, with_bpca)
        out[df.value] = {
            "input_reads": acc.input_reads,
            "weight_reads": acc.weight_reads,
            "output_writes": acc.output_writes,
            "psum_accesses": acc.psum_writes + acc.psum_reads,
            "total": acc.total,
        }
    return out
