"""Batched differential engine: one bitstream, thousands of memories.

Counterpart of ``src/repro/fuzz/engine.py``:

* :func:`batched_oracle`, a copy of the JAX package's: the serial oracle
  vectorized over a ``(B, M)`` memory batch in numpy int64, wrapped to
  int32 after every op.
* :func:`fuzz_program` chunks a corpus through
  :func:`repro_torch.cgra.simulator.execute_asm` (the PE array's batch
  axis, on the card by default), compares every last-iteration node value
  and the final memory image against the batched oracle, reports
  per-memory verdicts with the comparison contract of ``verify``, and
  harvests switching activity from each chunk's trace on its device.
* :func:`fuzz_kernel` maps a registry kernel through the port's
  ``Toolchain`` as the JAX package does (``map_time_s``; ``unmapped``,
  ``timeout`` and ``error`` when no mapping comes back), fuzzes the
  fresh artifact, adds the activity-based energy delta and, on a
  mismatch, optionally triages.
* :func:`run_stacked` / :func:`fuzz_stacked` stack NOP-padded bitstreams
  of one grid on a leading kernel axis, so one kernel launch executes K
  kernels x B memories.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cgra.arch import neighbor_table
from ..cgra.artifact import Artifact
from ..cgra.bitstream import AssembledCIL
from ..cgra.energy import runtime_metrics
from ..cgra.isa import FXP_FRAC_BITS, NOP
from ..cgra.programs import LoopBuilder, Val
from ..cgra.simulator import execute_asm, stacked_preset_state
from ..device import resolve_device
from ..kernels.ops import decode_fields, run_program
from ..kernels.ref import InstrRow, PEState
from .activity import ActivityAccumulator
from .corpus import make_corpus

M32 = (1 << 32) - 1
_SIGN = 1 << 31


def _wrap32(x) -> np.ndarray:
    """int64 array -> int64 holding signed-32-bit-wrapped values."""
    x = np.asarray(x, np.int64) & M32
    return x - ((x >= _SIGN).astype(np.int64) << 32)


def _alu_vec(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized ``isa.alu_semantics`` on int64 arrays that hold
    int32-wrapped values."""
    if op in ("SADD", "MOV"):
        return _wrap32(a + b)
    if op == "SSUB":
        return _wrap32(a - b)
    if op == "SMUL":
        return _wrap32(a * b)
    if op == "FXPMUL":
        return _wrap32((a * b) >> FXP_FRAC_BITS)
    if op == "SLT":
        return _wrap32(a << (b & 31))
    if op == "SRT":
        return _wrap32((a & M32) >> (b & 31))
    if op == "SRA":
        return _wrap32(a >> (b & 31))
    if op == "LAND":
        return _wrap32(a & b)
    if op == "LOR":
        return _wrap32(a | b)
    if op == "LXOR":
        return _wrap32(a ^ b)
    if op == "LNAND":
        return _wrap32(~(a & b))
    if op == "LNOR":
        return _wrap32(~(a | b))
    if op == "LXNOR":
        return _wrap32(~(a ^ b))
    if op in ("BEQ", "BNE", "BLT", "BGE"):
        return _wrap32(a - b)
    if op in ("JUMP", "EXIT", "NOP"):
        return np.zeros_like(a)
    raise ValueError(f"no ALU semantics for {op}")


def _gather(mem: np.ndarray, addr: np.ndarray) -> np.ndarray:
    """mem (B, M), addr scalar or (B,) -> (B,) loaded values."""
    if addr.ndim == 0:
        return mem[:, int(addr)].copy()
    return mem[np.arange(mem.shape[0]), addr]


def _scatter(mem: np.ndarray, addr: np.ndarray, val: np.ndarray) -> None:
    if addr.ndim == 0:
        mem[:, int(addr)] = val
    else:
        mem[np.arange(mem.shape[0]), addr] = val


def _batched_interpret(
    program: LoopBuilder, mems: np.ndarray, record_iterations: bool = False
) -> Tuple[Dict[int, np.ndarray], np.ndarray, List[Dict[int, np.ndarray]]]:
    """The serial oracle over a (B, M) batch.

    Returns (last-iteration node values, final memories, per-iteration
    node values when requested).  Values that depend only on the
    induction carries stay scalar until they meet batch data.  Addresses
    are range-checked like the serial oracle's list indexing.
    """
    mems = _wrap32(np.asarray(mems, np.int64))
    if mems.ndim == 1:
        mems = mems[None, :]
    B, M = mems.shape
    dfg = program.build_dfg()
    order = dfg.topo_order()
    carry_vals: Dict[int, np.ndarray] = {
        c.update: np.asarray(np.int64(c.init)) for c in program.carries}
    history: List[Dict[int, np.ndarray]] = []
    vals: Dict[int, np.ndarray] = {}
    for _ in range(program.trip):
        vals = {}
        flags: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for nid in order:
            a, b = program.node_srcs[nid]
            imm = program.node_imm[nid]
            op = dfg.nodes[nid].op

            def fetch(operand, use_imm):
                if operand is None:
                    return np.asarray(np.int64(imm if use_imm else 0))
                if isinstance(operand, int):
                    return np.asarray(np.int64(operand))
                if isinstance(operand, Val):
                    return vals[operand.node]
                return carry_vals[operand.update]

            av = fetch(a, a is None and op not in ("LWI", "SWI"))
            bv = fetch(b, b is None)
            if op in ("LWD", "LWI", "SWD", "SWI"):
                addr = av + (imm if op in ("LWI", "SWI") else 0)
                if (addr < 0).any() or (addr >= M).any():
                    raise IndexError(
                        f"{program.name}: node {nid} ({op}) address "
                        f"outside [0, {M})")
                if op in ("LWD", "LWI"):
                    out = _gather(mems, addr)
                else:
                    out = np.broadcast_to(bv, (B,)).astype(np.int64)
                    _scatter(mems, addr, out)
            elif op in ("BSFA", "BZFA"):
                sign, zero = flags[program.flag_deps[nid]]
                out = np.asarray(np.where(sign if op == "BSFA" else zero,
                                          av, bv), np.int64)
            else:
                out = _alu_vec(op, av, bv)
            vals[nid] = out
            flags[nid] = (out < 0, out == 0)
        for c in program.carries:
            carry_vals[c.update] = vals[c.update]
        if record_iterations:
            history.append({n: np.broadcast_to(v, (B,)).copy()
                            for n, v in vals.items()})
    final = {n: np.broadcast_to(v, (B,)) for n, v in vals.items()}
    return final, mems, history


def batched_oracle(
    program: LoopBuilder, mems: np.ndarray
) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
    """(last-iteration node values {nid: (B,)}, final memories (B, M))."""
    vals, final_mems, _ = _batched_interpret(program, mems)
    return vals, final_mems


def batched_oracle_iterations(
    program: LoopBuilder, mems: np.ndarray
) -> List[Dict[int, np.ndarray]]:
    """Per-iteration node values (one dict per trip iteration)."""
    _, _, history = _batched_interpret(program, mems, record_iterations=True)
    return history


# ---------------------------------------------------------------------------
# differential comparison (the simulator.verify contract, batched)
# ---------------------------------------------------------------------------


def compare_batch(
    sim_node_values: Dict[int, np.ndarray],
    sim_final_mem: np.ndarray,
    oracle_vals: Dict[int, np.ndarray],
    oracle_mem: np.ndarray,
) -> np.ndarray:
    """Per-memory failure mask (B,) over every last-iteration node value
    and the full final memory."""
    bad = np.zeros(sim_final_mem.shape[0], bool)
    for n, vals in sim_node_values.items():
        exp = oracle_vals.get(n)
        if exp is None:
            continue
        bad |= (np.asarray(vals, np.int64) & M32) != (exp & M32)
    bad |= ((np.asarray(sim_final_mem, np.int64) & M32)
            != (oracle_mem & M32)).any(axis=1)
    return bad


def mismatch_strings(
    program: LoopBuilder,
    sim_node_values: Dict[int, np.ndarray],
    sim_final_mem: np.ndarray,
    oracle_vals: Dict[int, np.ndarray],
    oracle_mem: np.ndarray,
    index: int,
    label: Optional[int] = None,
) -> List[str]:
    """The ``verify``-style mismatch lines for one memory of a batch
    (``index`` picks the row; ``label`` is the corpus-level id)."""
    tag = index if label is None else label
    errors: List[str] = []
    for n, vals in sim_node_values.items():
        exp = oracle_vals.get(n)
        if exp is None:
            continue
        got = int(vals[index]) & M32
        want = int(exp[index]) & M32
        if got != want:
            errors.append(f"mem {tag}: node {n} ({program.name}): "
                          f"sim {got:#x} != oracle {want:#x}")
    sim_mem = np.asarray(sim_final_mem[index], np.int64) & M32
    ref_mem = np.asarray(oracle_mem[index], np.int64) & M32
    for addr in np.nonzero(sim_mem != ref_mem)[0]:
        errors.append(f"mem {tag}: mem[{int(addr)}] sim "
                      f"{int(sim_mem[addr]):#x} != oracle "
                      f"{int(ref_mem[addr]):#x}")
    return errors


def node_values_from_outs(
    asm: AssembledCIL, outs: torch.Tensor, trip: int
) -> Dict[int, np.ndarray]:
    """Last-iteration per-node values from an out trace (T, B, P).  Only
    those cells leave the device."""
    cells = [(t, pe, n) for (t, pe), (n, j) in asm.node_of_cell.items()
             if j == trip - 1]
    if not cells:
        return {}
    ts, pes, nodes = zip(*cells)
    index = dict(device=outs.device, dtype=torch.long)
    picked = outs[torch.tensor(ts, **index), :,
                  torch.tensor(pes, **index)].cpu().numpy()
    return {n: picked[i] for i, n in enumerate(nodes)}


# ---------------------------------------------------------------------------
# batched execution over one kernel
# ---------------------------------------------------------------------------


@dataclass
class FuzzReport:
    """Verdict of one (kernel, arch) fuzz run."""

    kernel: str
    arch: str
    status: str                      # ok | mismatch | unmapped | timeout | error
    ii: Optional[int] = None
    memories: int = 0
    batch: int = 0
    backend: str = "cuda"            # cuda (the kernel) | ref (plain, CPU)
    failing: List[int] = field(default_factory=list)   # corpus indices
    mismatches: List[str] = field(default_factory=list)  # capped sample
    error: Optional[str] = None
    map_time_s: float = 0.0
    exec_time_s: float = 0.0
    oracle_time_s: float = 0.0
    mem_rate: float = 0.0            # memories verified per second
    activity: Optional[Dict] = None
    energy: Optional[Dict] = None    # static vs empirical dynamic energy
    reproducer: Optional[str] = None  # path written by triage
    divergence: Optional[Dict] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


_MISMATCH_SAMPLE_CAP = 8


def fuzz_program(artifact: Artifact, mems: np.ndarray, batch: int = 1024,
                 device="cuda", collect_activity: bool = True) -> FuzzReport:
    """Differentially fuzz one artifact over a corpus.

    Chunks ``mems`` (N, M) into batches of ``batch`` memories, executes
    each chunk in one ``run_program``, runs the batched oracle on the same
    chunk, and compares under the ``verify`` contract.  Activity
    statistics are harvested from each chunk's trace on its device.
    """
    dev = resolve_device(device)
    asm, program = artifact.asm, artifact.program
    mems = np.asarray(mems, np.int32)
    if mems.ndim == 1:
        mems = mems[None, :]
    n = mems.shape[0]
    rep = FuzzReport(kernel=artifact.kernel, arch=artifact.arch,
                     status="ok", ii=asm.ii, memories=n,
                     batch=min(batch, n) if n else batch,
                     backend=_backend(dev))
    acc = (ActivityAccumulator(asm, artifact.grid) if collect_activity
           else None)
    t_exec = t_oracle = 0.0
    t_total0 = time.monotonic()
    for lo in range(0, n, batch):
        chunk = mems[lo:lo + batch]
        t0 = time.monotonic()
        final, outs, _ = execute_asm(asm, artifact.grid, chunk,
                                     batch=chunk.shape[0], device=dev)
        sim_vals = node_values_from_outs(asm, outs, program.trip)
        sim_mem = final.mem.cpu().numpy()
        t_exec += time.monotonic() - t0
        t0 = time.monotonic()
        oracle_vals, oracle_mem = batched_oracle(program, chunk)
        t_oracle += time.monotonic() - t0
        bad = compare_batch(sim_vals, sim_mem, oracle_vals, oracle_mem)
        for i in np.nonzero(bad)[0]:
            rep.failing.append(lo + int(i))
            if len(rep.mismatches) < _MISMATCH_SAMPLE_CAP:
                rep.mismatches.extend(mismatch_strings(
                    program, sim_vals, sim_mem, oracle_vals, oracle_mem,
                    int(i), label=lo + int(i))[:_MISMATCH_SAMPLE_CAP])
        if acc is not None:
            acc.update(outs)
    wall = time.monotonic() - t_total0
    rep.exec_time_s = round(t_exec, 4)
    rep.oracle_time_s = round(t_oracle, 4)
    rep.mem_rate = round(n / wall, 2) if wall > 0 and n else 0.0
    rep.mismatches = rep.mismatches[:_MISMATCH_SAMPLE_CAP]
    if rep.failing:
        rep.status = "mismatch"
    if acc is not None:
        rep.activity = acc.report().to_dict()
    return rep


def _backend(dev: torch.device) -> str:
    return "cuda" if dev.type == "cuda" else "ref"


def fuzz_kernel(name: str, arch: str = "4x4", memories: int = 1024,
                batch: int = 1024, seed: int = 0, shrink: bool = False,
                config=None,
                failures_dir: str = "results/fuzz_failures",
                strategies: Optional[Sequence[str]] = None,
                device="cuda") -> FuzzReport:
    """Map one registry kernel on ``arch`` and fuzz it end to end:
    corpus -> batched differential run -> activity-based energy delta ->
    (on mismatch, with ``shrink``) shrink + divergence replay +
    reproducer JSON under ``failures_dir``.  A kernel that does not map
    comes back ``unmapped`` or ``timeout``; nothing else stands in for
    its mapping."""
    from ..core.mapper import MapperConfig
    from ..toolchain.session import Toolchain
    from .triage import triage_failure

    dev = resolve_device(device)
    cfg = config or MapperConfig(per_ii_timeout_s=60.0,
                                 total_timeout_s=120.0, ii_max=32)
    tc = Toolchain(arch, cfg)
    arch_name = tc.arch or f"{tc.grid.spec.rows}x{tc.grid.spec.cols}"
    prog = tc.program(name)
    t0 = time.monotonic()
    try:
        res = tc.map(prog)
    except Exception as e:
        return FuzzReport(kernel=name, arch=arch_name, status="error",
                          backend=_backend(dev),
                          error=f"{type(e).__name__}: {e}")
    map_time = round(time.monotonic() - t0, 3)
    if res.mapping is None:
        status = "timeout" if res.status == "timeout" else "unmapped"
        return FuzzReport(kernel=name, arch=arch_name, status=status,
                          backend=_backend(dev), map_time_s=map_time)
    artifact = Artifact.from_mapping(prog.builder, res.mapping,
                                     arch=arch_name)
    mems = make_corpus(name, memories, seed=seed, strategies=strategies)
    rep = fuzz_program(artifact, mems, batch=batch, device=dev)
    rep.map_time_s = map_time
    if rep.activity is not None:
        rep.energy = _energy_delta(artifact, rep.activity)
    if rep.failing and shrink:
        triage_failure(artifact, mems, rep, device=dev,
                       out_dir=failures_dir)
    return rep


def _energy_delta(artifact: Artifact, activity: Dict) -> Dict:
    """Static vs activity-based dynamic energy of one artifact: the JAX
    package's ``metrics_for_mapping`` pair, on the words the mapping
    assembled to.  The mapping's utilization enters neither energy; 0.0
    stands in for it."""
    cols = artifact.grid.cols
    static = runtime_metrics(artifact.asm, cols, 0.0)
    empirical = runtime_metrics(artifact.asm, cols, 0.0, activity=activity)
    delta = empirical.dynamic_nj - static.dynamic_nj
    pct = (100.0 * delta / static.dynamic_nj) if static.dynamic_nj else 0.0
    return {
        "static_dynamic_nj": round(static.dynamic_nj, 4),
        "empirical_dynamic_nj": round(empirical.dynamic_nj, 4),
        "delta_nj": round(delta, 4),
        "delta_pct": round(pct, 2),
        "static_total_nj": round(static.energy_nj, 4),
        "empirical_total_nj": round(empirical.energy_nj, 4),
    }


# ---------------------------------------------------------------------------
# kernel stacking: K bitstreams of one grid, one kernel launch
# ---------------------------------------------------------------------------

#: the word of a NOP row cell: it leaves all state untouched
_NOP_WORD = NOP.encode()


def _pad_words(words: np.ndarray, total_rows: int) -> np.ndarray:
    """NOP-pad a (T, P) bitstream to ``total_rows`` rows, as the JAX
    package's ``_pad_fields`` pads the decoded fields (a NOP word decodes
    to its op, dst, sa, sb and imm).  Padding at the end is inert."""
    pad = total_rows - words.shape[0]
    return np.concatenate(
        [words, np.full((pad, words.shape[1]), _NOP_WORD, np.uint32)])


def _pad_fields(fields: InstrRow, total_rows: int) -> InstrRow:
    """Decoded-field counterpart of :func:`_pad_words`: (T, P) fields of
    any program, NOP rows appended on their device."""
    T, P = fields.op.shape
    nop = decode_fields(np.full((total_rows - T, P), _NOP_WORD, np.uint32),
                        fields.op.device)
    return InstrRow(*(torch.cat([f, n]) for f, n in zip(fields, nop)))


def run_stacked(artifacts: Sequence[Artifact], mems: np.ndarray,
                device="cuda") -> Tuple[PEState, torch.Tensor]:
    """Execute K bitstreams of one grid over (K, B, M) memories, or one
    shared (B, M) corpus, in one ``run_program``: on the card one kernel
    launch.  Returns (final state with a leading K axis, outs (K, T_max, B,
    P)) on ``device``.  Shorter bitstreams are NOP-padded: rows past a
    kernel's real schedule execute nothing, so its ``node_of_cell`` indices
    stay valid."""
    dev = resolve_device(device)
    grid = artifacts[0].grid
    for art in artifacts:
        if art.grid != grid:
            raise ValueError(f"cannot stack {art.kernel}: grid {art.grid} "
                             f"!= {grid}")
    mems = np.asarray(mems, np.int32)
    if mems.ndim == 2:
        mems = np.broadcast_to(mems[None], (len(artifacts),) + mems.shape)
    K = mems.shape[0]
    if K != len(artifacts):
        raise ValueError(f"{len(artifacts)} bitstreams but {K} memory "
                         f"groups")
    t_max = max(art.asm.total_rows for art in artifacts)
    words = np.stack([_pad_words(art.asm.words(), t_max)
                      for art in artifacts])
    state = stacked_preset_state([art.asm for art in artifacts],
                                 grid.num_pes, mems, dev)
    return run_program(decode_fields(words, dev), state,
                       neighbor_table(grid), dev)


def fuzz_stacked(artifacts: Sequence[Artifact], mems: np.ndarray,
                 device="cuda") -> List[FuzzReport]:
    """Differentially fuzz K artifacts of one grid in one stacked run.
    ``mems`` is (B, M) (shared corpus) or (K, B, M).  Oracle comparison
    and verdicts are those of per-kernel :func:`fuzz_program`; execution
    time is split evenly over the K kernels."""
    dev = resolve_device(device)
    mems = np.asarray(mems, np.int32)
    if mems.ndim == 2:
        mems = np.broadcast_to(mems[None], (len(artifacts),) + mems.shape)
    t0 = time.monotonic()
    final, outs = run_stacked(artifacts, mems, device=dev)
    sim_mems = final.mem.cpu().numpy()
    exec_time = time.monotonic() - t0
    reports: List[FuzzReport] = []
    for k, art in enumerate(artifacts):
        program, asm = art.program, art.asm
        sim_vals = node_values_from_outs(asm, outs[k], program.trip)
        t1 = time.monotonic()
        oracle_vals, oracle_mem = batched_oracle(program, mems[k])
        oracle_time = time.monotonic() - t1
        bad = compare_batch(sim_vals, sim_mems[k], oracle_vals, oracle_mem)
        rep = FuzzReport(
            kernel=art.kernel, arch=art.arch, status="ok", ii=asm.ii,
            memories=int(mems.shape[1]), batch=int(mems.shape[1]),
            backend=_backend(dev),
            exec_time_s=round(exec_time / len(artifacts), 4),
            oracle_time_s=round(oracle_time, 4))
        share = exec_time / len(artifacts) + oracle_time
        rep.mem_rate = round(mems.shape[1] / share, 2) if share > 0 else 0.0
        for i in np.nonzero(bad)[0]:
            rep.failing.append(int(i))
            if len(rep.mismatches) < _MISMATCH_SAMPLE_CAP:
                rep.mismatches.extend(mismatch_strings(
                    program, sim_vals, sim_mems[k], oracle_vals, oracle_mem,
                    int(i))[:_MISMATCH_SAMPLE_CAP])
        rep.mismatches = rep.mismatches[:_MISMATCH_SAMPLE_CAP]
        if rep.failing:
            rep.status = "mismatch"
        reports.append(rep)
    return reports
