"""Batched differential engine: one bitstream, thousands of memories.

Counterpart of ``src/repro/fuzz/engine.py``:

* :func:`batched_oracle`, a copy of the JAX package's: the serial oracle
  vectorized over a ``(B, M)`` memory batch in numpy int64, wrapped to
  int32 after every op.
* :func:`fuzz_program` chunks a corpus through
  :func:`repro_torch.cgra.simulator.execute_asm` (the PE array's batch
  axis, on the card by default), judges every chunk by the one verdict
  step of this module (every last-iteration node value and the final
  memory image against the oracle: on the card the oracle kernel of
  :mod:`repro_torch.kernels.oracle`, which also makes the comparison
  there; on the CPU :func:`batched_oracle` and :func:`compare_batch`),
  reports per-memory verdicts with the comparison contract of ``verify``,
  and harvests switching activity from each chunk's trace on its device.
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

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cgra.artifact import Artifact
from ..cgra.bitstream import AssembledCIL
from ..cgra.energy import runtime_metrics
from ..cgra.isa import FXP_FRAC_BITS, NOP
from ..cgra.programs import LoopBuilder, Val
from ..cgra.simulator import (device_neighbors, execute_asm,
                              stacked_preset_state)
from ..device import resolve_device
from ..kernels.oracle import OracleVerdict, oracle_verdict
from ..kernels.ops import decode_fields, device_image, run_program
from ..kernels.pe_array import run_cycles
from ..kernels.ref import InstrRow, PEState
from ..obs import trace as obs_trace
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


#: mismatch lines a report keeps
_MISMATCH_SAMPLE_CAP = 8

#: int64 words of the final images that :func:`compare_batch` masks at a
#: time (1 MB): a whole batch's masks (16 MB each at 16,384 x 128) went
#: back to the OS when freed and were faulted in again every chunk
COMPARE_WORDS = 1 << 17


def compare_batch(
    sim_node_values: Dict[int, np.ndarray],
    sim_final_mem: np.ndarray,
    oracle_vals: Dict[int, np.ndarray],
    oracle_mem: np.ndarray,
) -> np.ndarray:
    """Per-memory failure mask (B,) over every last-iteration node value
    and the full final memory, the images in blocks of rows."""
    B, M = sim_final_mem.shape
    bad = np.zeros(B, bool)
    for n, vals in sim_node_values.items():
        exp = oracle_vals.get(n)
        if exp is None:
            continue
        bad |= (np.asarray(vals, np.int64) & M32) != (exp & M32)
    rows = max(1, COMPARE_WORDS // max(M, 1))
    for lo in range(0, B, rows):
        part = slice(lo, lo + rows)
        bad[part] |= ((np.asarray(sim_final_mem[part], np.int64) & M32)
                      != (oracle_mem[part] & M32)).any(axis=1)
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


def last_cells(asm: AssembledCIL, trip: int, keep=None
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """``(nodes, rows, pes)``: the trace cell that holds each node's
    last-iteration value, one a node, in ``asm.node_of_cell``'s order (a
    node two cells hold takes the later one, as a dict built from them
    does).  ``keep``, where given, holds the nodes to take."""
    cell: Dict[int, Tuple[int, int]] = {}
    for (t, pe), (n, j) in asm.node_of_cell.items():
        if j == trip - 1 and (keep is None or n in keep):
            cell[n] = (t, pe)
    return (tuple(cell), tuple(t for t, _ in cell.values()),
            tuple(pe for _, pe in cell.values()))


def node_values_from_outs(
    asm: AssembledCIL, outs: torch.Tensor, trip: int
) -> Dict[int, np.ndarray]:
    """Last-iteration per-node values from an out trace (T, B, P), on the
    host: the JAX package's helper.  The fuzz paths gather the same cells
    on the trace's device (``_VerdictStep.gather``)."""
    nodes, ts, pes = last_cells(asm, trip)
    if not nodes:
        return {}
    index = dict(device=outs.device, dtype=torch.long)
    picked = outs[torch.tensor(ts, **index), :,
                  torch.tensor(pes, **index)].cpu().numpy()
    return dict(zip(nodes, picked))


class _VerdictStep:
    """The fuzz verdict of one artifact's batches on one device, the one
    step by which every path judges memories (:func:`fuzz_program`,
    :func:`fuzz_stacked`, triage's probes and reproducer).

    The compared nodes are the program's that :func:`last_cells` finds,
    each with its slot, its place in the DFG's topological order: on the
    card the slots of ``artifact.oracle_table``, on the CPU the same order
    without compiling the table, so that a program the table refuses
    still fuzzes there.  No node is compared where the trip is 0."""

    def __init__(self, artifact: Artifact, dev: torch.device):
        program = artifact.program
        self.program, self.dev = program, dev
        card = dev.type == "cuda"
        self.backend = "cuda" if card else "numpy"
        self.table = artifact.oracle_table if card else None
        order = ((self.table.node_ids if card
                  else program.build_dfg().topo_order())
                 if program.trip > 0 else ())
        slot_of = {n: i for i, n in enumerate(order)}
        self.order = tuple(order)
        self.nodes, ts, pes = last_cells(artifact.asm, program.trip,
                                         keep=slot_of)
        self.slots = tuple(slot_of[n] for n in self.nodes)
        index = dict(device=dev, dtype=torch.long)
        self.cells = (torch.tensor(ts, **index), slice(None),
                      torch.tensor(pes, **index))

    def gather(self, outs: torch.Tensor) -> torch.Tensor:
        """The compared nodes' last-iteration values from a trace (T, B,
        P): (K, B) on its device, in :attr:`nodes` order."""
        return outs[self.cells].contiguous()

    def judge(self, mems: torch.Tensor, sim_mem: torch.Tensor,
              sim_vals: torch.Tensor) -> OracleVerdict:
        """The oracle over ``mems``, the (B, M) int32 images the run
        started from, on the step's device (on the card the very tensor
        the PE array read), and the memories whose final image ``sim_mem``
        or values ``sim_vals`` (from :meth:`gather`) differ from it.  On
        the card one :func:`~repro_torch.kernels.oracle.oracle_verdict`
        launch; on the CPU :func:`batched_oracle` and
        :func:`compare_batch`, the JAX package's contract, with the
        oracle's images and values a slot as CPU tensors."""
        if self.table is not None:
            return oracle_verdict(self.table, mems.contiguous(),
                                  sim_mem.contiguous(), sim_vals, self.slots)
        vals, image = batched_oracle(self.program, mems.numpy())
        bad = compare_batch(dict(zip(self.nodes, sim_vals.numpy())),
                            sim_mem.numpy(), vals, image)
        per_slot = np.array([vals[n] for n in self.order], np.int64)
        return OracleVerdict(bad, torch.from_numpy(image), torch.from_numpy(
            per_slot.reshape(len(self.order), len(image))))

    def mismatches(self, sim_vals: torch.Tensor, sim_mem: torch.Tensor,
                   verdict: OracleVerdict, failing: np.ndarray, lo: int,
                   lines: List[str], cap: int = _MISMATCH_SAMPLE_CAP) -> int:
        """Extend ``lines`` by :func:`mismatch_strings` of each failing row
        in turn (``failing``, ascending, in the batch that starts at corpus
        index ``lo``) until they hold ``cap`` lines, as the JAX package
        samples them.  Only the rows it asks about leave the operands'
        device: ``sim_vals`` and ``sim_mem`` of :meth:`judge`, the
        verdict's images and values.  Returns the rows copied back."""
        back = 0
        pick = np.asarray(self.slots, np.intp)
        while len(lines) < cap and back < len(failing):
            take = failing[back:back + cap - len(lines)]
            back += len(take)
            rows = torch.as_tensor(take, dtype=torch.long,
                                   device=sim_mem.device)
            sim_v = sim_vals.index_select(1, rows).cpu().numpy()
            want_v = verdict.vals.index_select(1, rows).cpu().numpy()[pick]
            sim_m = sim_mem.index_select(0, rows).cpu().numpy()
            want_m = verdict.image.index_select(0, rows).cpu().numpy()
            got, want = dict(zip(self.nodes, sim_v)), dict(zip(self.nodes,
                                                               want_v))
            for j, i in enumerate(take):
                if len(lines) >= cap:
                    break
                lines.extend(mismatch_strings(
                    self.program, got, sim_m, want, want_m, j,
                    label=lo + int(i))[:cap])
        return back


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
    exec_time_s: float = 0.0         # fuzz.execute + fuzz.readback spans
    oracle_time_s: float = 0.0
    readback_time_s: float = 0.0     # the part of exec_time_s after launch
    compare_time_s: float = 0.0
    activity_time_s: float = 0.0
    activity_setup_s: float = 0.0    # the part of activity_time_s before
                                     # the first chunk (the replay)
    ring_launches: int = 0           # run_cycles launches from a ring
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


#: the phases of a :func:`fuzz_program` chunk, each a ``fuzz.<phase>``
#: span and the source of one ``FuzzReport`` time
_PHASES = ("execute", "readback", "oracle", "compare", "activity")


@contextlib.contextmanager
def _phase(times: Dict[str, float], phase: str, **attrs):
    """A ``fuzz.<phase>`` span whose duration adds to ``times[phase]``."""
    sp = obs_trace.timed_span(f"fuzz.{phase}", **attrs)
    with sp:
        yield sp
    times[phase] += sp.dur


def fuzz_program(artifact: Artifact, mems: np.ndarray, batch: int = 1024,
                 device="cuda", collect_activity: bool = True) -> FuzzReport:
    """Differentially fuzz one artifact over a corpus.

    Chunks ``mems`` (N, M) into batches of ``batch`` memories, executes
    each chunk in one ``run_program``, runs the batched oracle on the same
    chunk, and compares under the ``verify`` contract.  Activity
    statistics are harvested from each chunk's trace on its device.

    Each chunk crosses to the device once (:func:`device_image`): the PE
    array starts from that tensor and the verdict step (``_VerdictStep``)
    reads the same one.  On the
    card the oracle is one launch of the oracle kernel over the
    artifact's compiled table (``Artifact.oracle_table``), with the verdict
    epilogue (:func:`~repro_torch.kernels.oracle.oracle_verdict`): the
    chunk's final images and last-iteration node values stay on the card,
    only the verdict mask comes back, and the four operands of a failing
    row only where :func:`mismatch_strings` is asked about it.  On the
    CPU the oracle is :func:`batched_oracle` and the comparison
    :func:`compare_batch`.  Both give the same failing memories and
    mismatch lines.

    Every phase is a span (:mod:`repro_torch.obs.trace`) under
    ``fuzz.program``, one ``fuzz.chunk`` a chunk (attributes ``lo``,
    ``rows`` and ``upload_bytes``, the bytes the chunk copied to the card,
    0 on the CPU): ``fuzz.execute``
    (the chunk's one upload, the presets broadcast on the device and the
    launch's enqueue; the words, presets and neighbour table come from
    :func:`~repro_torch.cgra.simulator.device_program`, built once a
    bitstream), ``fuzz.readback`` (the
    gather of the node values into a (K, B) tensor on the trace's
    device), ``fuzz.oracle`` (attribute ``backend``, ``cuda`` or
    ``numpy``; on the card the launch, the verdict's copy back and the
    wait), ``fuzz.compare`` (attributes ``backend`` and
    ``rows_back``, the failing rows copied back) and ``fuzz.activity``
    (also the accumulator's set-up, attribute ``cells``, the executed
    cells its replay resolves, and its report).  ``fuzz.program`` also
    carries the program's ``rows`` and the image's ``mem_words``.
    The report's times are their projections: ``exec_time_s`` is execute
    + readback, ``activity_setup_s`` the set-up's part of
    ``activity_time_s``.  Where ``fuzz.execute`` makes a launch it
    carries, from ``run_cycles.last_geometry``, the launch's
    ``pes_per_warp`` (in the lane layout a warp holds every PE of its
    batch rows) and ``chunk_rows`` (below the program's rows, the
    program runs from a ring); ``ring_launches`` counts the launches
    that did
    (``run_cycles.ring_launches``).
    """
    dev = resolve_device(device)
    asm = artifact.asm
    mems = np.asarray(mems, np.int32)
    if mems.ndim == 1:
        mems = mems[None, :]
    n = mems.shape[0]
    rep = FuzzReport(kernel=artifact.kernel, arch=artifact.arch,
                     status="ok", ii=asm.ii, memories=n,
                     batch=min(batch, n) if n else batch,
                     backend=_backend(dev))
    times = dict.fromkeys(_PHASES, 0.0)
    step = _VerdictStep(artifact, dev)
    rings = run_cycles.ring_launches
    root = obs_trace.timed_span("fuzz.program", kernel=artifact.kernel,
                                memories=n, batch=rep.batch,
                                chunks=-(-n // batch), rows=asm.total_rows,
                                mem_words=mems.shape[1])
    with root:
        acc = None
        if collect_activity:
            with _phase(times, "activity", part="setup") as sp:
                acc = ActivityAccumulator(asm, artifact.grid, dev)
                sp.set(cells=acc.cells)
            rep.activity_setup_s = round(sp.dur, 4)
        for lo in range(0, n, batch):
            chunk = mems[lo:lo + batch]
            with obs_trace.timed_span("fuzz.chunk", lo=lo,
                                      rows=chunk.shape[0]) as chunk_sp:
                with _phase(times, "execute") as sp:
                    launches = run_cycles.launches
                    image = device_image(chunk, chunk.shape[0], dev)
                    chunk_sp.set(upload_bytes=image.nbytes
                                 if dev.type == "cuda" else 0)
                    final, outs, _ = execute_asm(
                        asm, artifact.grid, image, batch=chunk.shape[0],
                        device=dev)
                    if run_cycles.launches > launches:
                        geom = run_cycles.last_geometry
                        sp.set(pes_per_warp=geom.warp_pes(asm.num_pes),
                               chunk_rows=geom.chunk_rows)
                with _phase(times, "readback"):
                    sim_vals = step.gather(outs)
                with _phase(times, "oracle", backend=step.backend):
                    verdict = step.judge(image, final.mem, sim_vals)
                with _phase(times, "compare", backend=step.backend) as sp:
                    bad = np.nonzero(verdict.bad)[0]
                    rep.failing.extend((lo + bad).tolist())
                    sp.set(rows_back=step.mismatches(
                        sim_vals, final.mem, verdict, bad, lo,
                        rep.mismatches))
                    # the oracle's device buffer and the chunk's image go
                    # before the next chunk's trace is made
                    verdict = image = None
                if acc is not None:
                    with _phase(times, "activity"):
                        acc.update(outs)
        if acc is not None:
            with _phase(times, "activity", part="report"):
                rep.activity = acc.report().to_dict()
    rep.exec_time_s = round(times["execute"] + times["readback"], 4)
    rep.readback_time_s = round(times["readback"], 4)
    rep.oracle_time_s = round(times["oracle"], 4)
    rep.compare_time_s = round(times["compare"], 4)
    rep.activity_time_s = round(times["activity"], 4)
    rep.ring_launches = run_cycles.ring_launches - rings
    rep.mem_rate = round(n / root.dur, 2) if root.dur > 0 and n else 0.0
    rep.mismatches = rep.mismatches[:_MISMATCH_SAMPLE_CAP]
    if rep.failing:
        rep.status = "mismatch"
    return rep


def _backend(dev: torch.device) -> str:
    return "cuda" if dev.type == "cuda" else "ref"


def fuzz_kernel(name: str, arch: str = "4x4", memories: int = 1024,
                batch: int = 1024, seed: int = 0, shrink: bool = False,
                config=None, cache=None,
                failures_dir: str = "results/fuzz_failures",
                strategies: Optional[Sequence[str]] = None,
                device="cuda") -> FuzzReport:
    """Map one registry kernel on ``arch`` and fuzz it end to end:
    corpus -> batched differential run -> activity-based energy delta ->
    (on mismatch, with ``shrink``) shrink + divergence replay +
    reproducer JSON under ``failures_dir``.  A kernel that does not map
    comes back ``unmapped`` or ``timeout``; nothing else stands in for
    its mapping.  ``cache`` (a directory or a
    :class:`~repro_torch.dse.cache.MappingCache`) answers a repeat mapping
    from disk, as ``Toolchain(cache=)`` does.

    The call is a ``fuzz.kernel`` span whose children are its stages:
    ``fuzz.setup``, ``fuzz.map`` (``map_time_s`` is its duration),
    ``fuzz.assemble``, ``fuzz.corpus``, ``fuzz.program``, ``fuzz.energy``
    and, on a mismatch with ``shrink``, ``fuzz.triage``."""
    with obs_trace.timed_span("fuzz.kernel", kernel=name, arch=arch):
        with obs_trace.timed_span("fuzz.setup"):
            from ..core.mapper import MapperConfig
            from ..toolchain.session import Toolchain
            from .triage import triage_failure

            dev = resolve_device(device)
            cfg = config or MapperConfig(per_ii_timeout_s=60.0,
                                         total_timeout_s=120.0, ii_max=32)
            tc = Toolchain(arch, cfg, cache=cache)
            arch_name = (tc.arch
                         or f"{tc.grid.spec.rows}x{tc.grid.spec.cols}")
            prog = tc.program(name)
        msp = obs_trace.timed_span("fuzz.map", kernel=name)
        try:
            with msp:
                res = tc.map(prog)
                msp.set(cache_hit=tc.last_cache_hit, status=res.status)
        except Exception as e:
            return FuzzReport(kernel=name, arch=arch_name, status="error",
                              backend=_backend(dev),
                              error=f"{type(e).__name__}: {e}")
        map_time = round(msp.dur, 3)
        if res.mapping is None:
            status = "timeout" if res.status == "timeout" else "unmapped"
            return FuzzReport(kernel=name, arch=arch_name, status=status,
                              backend=_backend(dev), map_time_s=map_time)
        with obs_trace.timed_span("fuzz.assemble"):
            artifact = Artifact.from_mapping(prog.builder, res.mapping,
                                             arch=arch_name)
        with obs_trace.timed_span("fuzz.corpus", memories=memories):
            mems = make_corpus(name, memories, seed=seed,
                               strategies=strategies)
        rep = fuzz_program(artifact, mems, batch=batch, device=dev)
        rep.map_time_s = map_time
        if rep.activity is not None:
            with obs_trace.timed_span("fuzz.energy"):
                rep.energy = _energy_delta(artifact, rep.activity)
        if rep.failing and shrink:
            with obs_trace.timed_span("fuzz.triage"):
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


def run_stacked(artifacts: Sequence[Artifact], mems,
                device="cuda") -> Tuple[PEState, torch.Tensor]:
    """Execute K bitstreams of one grid over (K, B, M) memories, or one
    shared (B, M) corpus, host arrays or tensors on ``device`` (used as
    they are), in one ``run_program``: on the card one kernel
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
    image = _stacked_image(mems, len(artifacts), dev)
    K = image.shape[0]
    if K != len(artifacts):
        raise ValueError(f"{len(artifacts)} bitstreams but {K} memory "
                         f"groups")
    t_max = max(art.asm.total_rows for art in artifacts)
    words = np.stack([_pad_words(art.asm.words(), t_max)
                      for art in artifacts])
    state = stacked_preset_state([art.asm for art in artifacts],
                                 grid.num_pes, image, dev)
    return run_program(decode_fields(words, dev), state,
                       device_neighbors(grid, dev), dev)


def _stacked_image(mems, K: int, dev: torch.device) -> torch.Tensor:
    """(K, B, M) memories, or one (B, M) corpus shared by K kernels, as a
    (K, B, M) tensor on ``dev``: one upload, the shared corpus expanded
    there."""
    if not isinstance(mems, torch.Tensor):
        mems = np.asarray(mems, np.int32)
    image = device_image(mems, mems.shape[-2], dev)
    return image.expand(K, *image.shape) if image.dim() == 2 else image


def fuzz_stacked(artifacts: Sequence[Artifact], mems: np.ndarray,
                 device="cuda") -> List[FuzzReport]:
    """Differentially fuzz K artifacts of one grid in one stacked run.
    ``mems`` is (B, M) (shared corpus) or (K, B, M).  Each kernel is
    judged by the verdict step of :func:`fuzz_program` (on the card one
    oracle launch a kernel), with its verdicts; execution time, up to the
    launch's end, is split evenly over the K kernels."""
    dev = resolve_device(device)
    t0 = time.monotonic()
    image = _stacked_image(mems, len(artifacts), dev)
    final, outs = run_stacked(artifacts, image, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    exec_time = time.monotonic() - t0
    reports: List[FuzzReport] = []
    for k, art in enumerate(artifacts):
        step = _VerdictStep(art, dev)
        t1 = time.monotonic()
        sim_vals = step.gather(outs[k])
        verdict = step.judge(image[k], final.mem[k], sim_vals)
        oracle_time = time.monotonic() - t1
        bad = np.nonzero(verdict.bad)[0]
        rep = FuzzReport(
            kernel=art.kernel, arch=art.arch, status="ok", ii=art.asm.ii,
            memories=int(image.shape[1]), batch=int(image.shape[1]),
            backend=_backend(dev), failing=bad.tolist(),
            exec_time_s=round(exec_time / len(artifacts), 4),
            oracle_time_s=round(oracle_time, 4))
        share = exec_time / len(artifacts) + oracle_time
        rep.mem_rate = round(image.shape[1] / share, 2) if share > 0 else 0.0
        step.mismatches(sim_vals, final.mem[k], verdict, bad, 0,
                        rep.mismatches)
        rep.mismatches = rep.mismatches[:_MISMATCH_SAMPLE_CAP]
        if rep.failing:
            rep.status = "mismatch"
        reports.append(rep)
    return reports
