"""Run-time latency/energy model for assembled CILs.

A copy of the ``grid=None`` path of ``src/repro/cgra/energy.py``: the
calibrated per-op energies, per-PE per-cycle static power and row latency
(a load row takes 2 cycles, +1 per extra concurrent load in one column and
per extra concurrent store), and the activity scaling that turns measured
toggle rates (``repro_torch.fuzz.activity``) into an empirical dynamic
energy.  The constants are for relative comparisons, never absolute
silicon claims.

Not copied: ``pe_area``, ``arch_area`` and the ``grid=`` scaling of the
static term, which read the capability tables of the JAX package's
``PEGrid``; the port's ``Grid`` has none.  They come with the mapper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .artifact import AssembledCIL
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
#: toggle rate the per-op energies are calibrated at (random data: each
#: operand/result bit flips half the time); measured activity scales each
#: op's dynamic energy by ``measured_rate / ACTIVITY_REF``
ACTIVITY_REF = 0.5


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
    """Per-op dynamic-energy scale factors from measured switching activity
    (an ``ActivityReport`` or its ``to_dict()`` form): the mean of an op's
    result- and operand-bus toggle rates over the calibration rate; ops
    the activity never saw keep 1.0."""
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


def runtime_metrics(asm: AssembledCIL, num_cols: int, utilization: float,
                    activity=None) -> RuntimeMetrics:
    """Latency and energy of one pass over ``asm``'s schedule.
    ``activity=`` (an activity report) replaces the random-data switching
    assumption with measured toggle rates; the static term is untouched."""
    cycles = sum(row_latency(row, num_cols) for row in asm.rows)
    scales = _activity_scales(activity) if activity is not None else {}
    dynamic = sum(count * OP_ENERGY.get(op, _DEFAULT_OP_ENERGY)
                  * scales.get(op, 1.0)
                  for op, count in sorted(asm.op_counts().items()))
    static = cycles * asm.num_pes * STATIC_PJ_PER_PE_CYCLE
    return RuntimeMetrics(cycles=cycles,
                          energy_nj=(dynamic + static) / 1000.0,
                          ii=asm.ii, utilization=utilization,
                          dynamic_nj=dynamic / 1000.0,
                          static_nj=static / 1000.0)
