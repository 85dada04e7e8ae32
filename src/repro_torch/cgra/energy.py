"""Run-time latency/energy model for mapped CILs (paper §6-7 analogue).

Post-synthesis simulation is not reproducible offline, so run-time metrics
come from a calibrated model over the assembled instruction grid:

* latency: 1 cycle per CGRA-instruction row, 2 if the row contains a load
  (OpenEdgeCGRA loads take 2 cycles); +1 per extra concurrent load in the
  same column (per-column memory port serialization) and +1 per extra
  concurrent store to the same bank (pipelined stores)  — the paper's §7.2
  arbitration effects.
* energy: per-op energy weights (multipliers cost ~4x an add — §7.2 notes
  the ISA is not optimized for multiplications) + per-PE per-cycle static
  power.  Constants are calibrated to land in the paper Table 7 nJ range at
  100 MHz / 65 nm; we use them for *relative* comparisons (Pareto fronts),
  never as absolute silicon claims.
* area (heterogeneous specs): each PE pays for what it instantiates —
  ALU + routing always, a load-store unit / multiplier / register words
  only where the capability table grants them.  ``arch_area`` is the DSE
  area objective; passing ``grid=`` to :func:`runtime_metrics` scales the
  static term by the same table, calibrated so the all-capable 4-register
  PE reproduces the homogeneous constant exactly.

A copy of ``src/repro/cgra/energy.py``; measured activity comes from
:mod:`repro_torch.fuzz.activity`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .arch import PEGrid
from .bitstream import AssembledCIL
from .isa import LOAD_OPS, MUL_OPS, STORE_OPS

# pJ per executed op
OP_ENERGY: Dict[str, float] = {}
_DEFAULT_OP_ENERGY = 1.0
for _op in MUL_OPS:
    OP_ENERGY[_op] = 4.0
for _op in LOAD_OPS + STORE_OPS:
    OP_ENERGY[_op] = 6.0
OP_ENERGY["NOP"] = 0.0
STATIC_PJ_PER_PE_CYCLE = 1.3   # leakage + clock tree + config readout
#: toggle rate the static per-op energies are calibrated at (random data:
#: each operand/result bit flips half the time).  Empirical activity from
#: ``repro_torch.fuzz.activity`` scales each op's dynamic energy by
#: ``measured_rate / ACTIVITY_REF``.
ACTIVITY_REF = 0.5

# relative area units per PE building block (65 nm-class ratios; the DSE
# area objective and the capability-scaled static model, never absolute)
PE_BASE_AREA = 1.0             # ALU, routing, config + flag logic
LSU_AREA = 0.45                # load-store unit + shared-port wiring
MUL_AREA = 0.65                # 32-bit multiplier
REG_AREA_PER_WORD = 0.05       # register file, per word
#: the reference all-capable 4-register PE: the calibration point where
#: the capability-aware static model coincides with the homogeneous one
FULL_PE_AREA = PE_BASE_AREA + LSU_AREA + MUL_AREA + 4 * REG_AREA_PER_WORD


def pe_area(grid: PEGrid, pe: int) -> float:
    """Relative area of one PE under the grid's capability table."""
    caps = grid.caps
    area = PE_BASE_AREA + grid.spec.num_regs * REG_AREA_PER_WORD
    if caps is None or caps.mem_pes is None or pe in caps.mem_pes:
        area += LSU_AREA
    if caps is None or caps.mul_pes is None or pe in caps.mul_pes:
        area += MUL_AREA
    return area


def arch_area(grid: PEGrid) -> float:
    """Relative fabric area (sum of per-PE areas) — the DSE objective a
    heterogeneity actually buys down."""
    return round(sum(pe_area(grid, p) for p in range(grid.num_pes)), 6)


@dataclass
class RuntimeMetrics:
    cycles: int
    energy_nj: float
    ii: int
    utilization: float
    dynamic_nj: float = 0.0    # per-op switching energy
    static_nj: float = 0.0     # leakage/clock, scales with PEs x cycles

    @property
    def latency_us_at_100mhz(self) -> float:
        return self.cycles / 100.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "cycles": self.cycles,
            "energy_nj": round(self.energy_nj, 4),
            "dynamic_nj": round(self.dynamic_nj, 4),
            "static_nj": round(self.static_nj, 4),
            "ii": self.ii,
            "utilization": round(self.utilization, 4),
        }


def row_latency(row, num_cols: int) -> int:
    """Cycles consumed by one instruction row (arbitration included)."""
    base = 1
    loads_per_col: Dict[int, int] = {}
    stores = 0
    for pe, ins in enumerate(row):
        if ins.op in LOAD_OPS:
            col = pe % num_cols
            loads_per_col[col] = loads_per_col.get(col, 0) + 1
            base = 2
        elif ins.op in STORE_OPS:
            stores += 1
    extra = sum(c - 1 for c in loads_per_col.values() if c > 1)
    extra += max(0, stores - 1)
    return base + extra


def _activity_scales(activity) -> Dict[str, float]:
    """Per-op dynamic-energy scale factors from measured switching
    activity (an ``ActivityReport`` or its ``to_dict()`` form).  An op's
    scale is the mean of its result- and operand-bus toggle rates over
    the calibration rate; ops the activity never saw keep 1.0."""
    if isinstance(activity, dict):
        res = activity.get("result_toggle", {})
        opnd = activity.get("operand_toggle", {})
    else:
        res = activity.result_toggle
        opnd = activity.operand_toggle
    scales: Dict[str, float] = {}
    for op in set(res) | set(opnd):
        rates = [r for r in (res.get(op), opnd.get(op)) if r is not None]
        scales[op] = (sum(rates) / len(rates)) / ACTIVITY_REF
    return scales


def runtime_metrics(asm: AssembledCIL, num_cols: int,
                    utilization: float,
                    grid: Optional[PEGrid] = None,
                    activity=None) -> RuntimeMetrics:
    """``grid=None`` keeps the calibrated homogeneous static constant
    (byte-identical committed baselines); passing a grid scales leakage
    by its capability table (== the constant for all-capable 4-reg PEs).
    ``activity=`` (a ``repro_torch.fuzz.activity`` report) replaces the implicit
    random-data switching assumption with measured toggle rates; the
    static term and the ``activity=None`` path are untouched."""
    cycles = sum(row_latency(row, num_cols) for row in asm.rows)
    scales = _activity_scales(activity) if activity is not None else {}
    dynamic = sum(count * OP_ENERGY.get(op, _DEFAULT_OP_ENERGY)
                  * scales.get(op, 1.0)
                  for op, count in sorted(asm.op_counts().items()))
    if grid is None:
        static = cycles * asm.num_pes * STATIC_PJ_PER_PE_CYCLE
    else:
        static = cycles * STATIC_PJ_PER_PE_CYCLE \
            * arch_area(grid) / FULL_PE_AREA
    return RuntimeMetrics(cycles=cycles,
                          energy_nj=(dynamic + static) / 1000.0,
                          ii=asm.ii, utilization=utilization,
                          dynamic_nj=dynamic / 1000.0,
                          static_nj=static / 1000.0)


def metrics_for_mapping(program, mapping,
                        activity=None) -> RuntimeMetrics:
    """Assemble ``mapping`` and run the calibrated model — the one-call
    metrics path (no execution involved).
    ``activity=`` threads measured switching statistics through to
    :func:`runtime_metrics`."""
    from .bitstream import assemble
    asm = assemble(program, mapping)
    return runtime_metrics(asm, num_cols=mapping.grid.spec.cols,
                           utilization=mapping.utilization,
                           activity=activity)
