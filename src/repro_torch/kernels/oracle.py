"""The fuzz oracle on the card: a compiled table of a CIL program and the
hand-written CUDA interpreter that runs it, one memory a thread
(``csrc/oracle.cu``).

:func:`compile_oracle` turns a :class:`~repro_torch.cgra.programs.LoopBuilder`
into an :class:`OracleTable`: small int32 arrays that hold, for each node
in the DFG's topological order, its operation, the kind and argument of
each operand, its immediate and its flag producer, and for each carry its
update slot and initial value.  :func:`oracle_verdict` runs the table over
a ``(B, M)`` int32 memory batch on the card, in one launch of
``oracle_kernel``, and compares there the simulator's final images and
node values with the oracle's: only one verdict word a memory comes back,
and the oracle's images and node values stay on the card.
:func:`oracle_ref` (what :func:`repro_torch.fuzz.engine.batched_oracle`
returns, ``({nid: (B,) int64}, (B, M) int64)`` of int32-wrapped values)
and :func:`oracle_verdict_ref` are the plain PyTorch versions, on any
device.

The semantics are those of ``fuzz/engine.py::_batched_interpret`` op for
op, written from its ``_alu_vec`` and not from the PE array's ALU: the
oracle is what the simulator is judged against, so the two share no code.
The one difference in kind is that the table refuses (``ValueError``) a
program whose constants, immediates or carry initial values do not all fit
in signed 32 bits; only then is every value the numpy oracle produces an
int32, so that int32 arithmetic with a 64-bit FXPMUL product is exact.

The kernel replaces no TPU kernel: the JAX package runs this oracle in
numpy on the host (``repro/fuzz/engine.py::batched_oracle``), and the
port moved it to the card because it set the pace of the fuzz path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..cgra.isa import FXP_FRAC_BITS
from ..cgra.programs import Carry, LoopBuilder, Val
from . import build
from .pe_array import _stream

#: operation classes of the table, in the order of ``csrc/oracle.cu``'s
#: ``OpClass``
ADD, SUB, MUL, FXPMUL, SHL, SHR_LOGICAL, SHR_ARITH, AND, OR, XOR, NAND, \
    NOR, XNOR, ZERO, LOAD, STORE, SELECT_SIGN, SELECT_ZERO = range(18)
_OP_CLASS = {
    "SADD": ADD, "MOV": ADD, "SSUB": SUB, "SMUL": MUL, "FXPMUL": FXPMUL,
    "SLT": SHL, "SRT": SHR_LOGICAL, "SRA": SHR_ARITH, "LAND": AND,
    "LOR": OR, "LXOR": XOR, "LNAND": NAND, "LNOR": NOR, "LXNOR": XNOR,
    "BEQ": SUB, "BNE": SUB, "BLT": SUB, "BGE": SUB,
    "JUMP": ZERO, "EXIT": ZERO, "NOP": ZERO,
    "LWD": LOAD, "LWI": LOAD, "SWD": STORE, "SWI": STORE,
    "BSFA": SELECT_SIGN, "BZFA": SELECT_ZERO,
}
#: operand kinds
NONE, INT, VAL, CARRY = range(4)
#: bits of a node's flags word
A_TAKES_IMM = 1      # an absent operand a reads the immediate, else 0
ADDRESS_ADDS_IMM = 2  # LWI / SWI: the address is a + imm
#: int32 words of a node record: op class, a kind, a arg, b kind, b arg,
#: imm, flags, flag producer's slot (-1 for none)
RECORD = 8
#: the error word when no address left [0, M)
NO_ERROR = -1

THREADS = 32                       # memories a block: one warp
MAX_SHARED_BYTES = 232_448         # 227 KB a block on sm_90

_INT32 = (-(1 << 31), (1 << 31) - 1)
_M32 = (1 << 32) - 1


@dataclass
class OracleTable:
    """A CIL program compiled for the oracle kernel.  ``nodes`` (N, RECORD)
    int32 in topological order; ``carry_update`` (C,) the slot (position
    in that order) each carry takes after an iteration, ``carry_init`` (C,)
    its value before the first; one carry slot per distinct update node,
    as the numpy oracle keys its carries."""

    name: str
    trip: int
    node_ids: Tuple[int, ...]          # nid of each slot
    ops: Tuple[str, ...]               # op name of each slot
    nodes: np.ndarray
    carry_update: np.ndarray
    carry_init: np.ndarray
    #: :meth:`packed` on each device it was asked for
    _on_device: Dict[torch.device, torch.Tensor] = field(
        default_factory=dict, repr=False, compare=False)
    #: :meth:`slots_on_device`'s copies, by device and slots
    _slots: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = \
        field(default_factory=dict, repr=False, compare=False)

    def packed(self) -> np.ndarray:
        """The table as the kernel reads it, one int32 array: the node
        records, then ``carry_update``, then ``carry_init``."""
        return np.concatenate([self.nodes.ravel(), self.carry_update,
                               self.carry_init]).astype(np.int32)

    def on_device(self, device: torch.device) -> torch.Tensor:
        """:meth:`packed` on ``device``, copied there once."""
        if device not in self._on_device:
            self._on_device[device] = torch.as_tensor(self.packed(),
                                                      device=device)
        return self._on_device[device]

    def slots_on_device(self, slots: Tuple[int, ...],
                        device: torch.device) -> torch.Tensor:
        """``slots`` as int32 on ``device``, copied there once."""
        key = (device, slots)
        if key not in self._slots:
            self._slots[key] = torch.tensor(slots, dtype=torch.int32,
                                            device=device)
        return self._slots[key]

    def address_error(self, code: int, M: int) -> IndexError:
        """The numpy oracle's error for the access at ``code`` = iteration
        x N + slot."""
        slot = code % len(self.node_ids)
        return IndexError(f"{self.name}: node {self.node_ids[slot]} "
                          f"({self.ops[slot]}) address outside [0, {M})")


def _int32(program: LoopBuilder, what: str, value: int) -> int:
    if not _INT32[0] <= value <= _INT32[1]:
        raise ValueError(f"{program.name}: {what} {value} does not fit in "
                         f"signed 32 bits")
    return value


def compile_oracle(program: LoopBuilder) -> OracleTable:
    """The table of ``program``.  Raises ``ValueError`` for a constant,
    immediate or carry initial value outside signed 32 bits, an op without
    semantics, a flag consumer without a producer or a carry never set.
    ``Artifact.oracle_table`` keeps one a artifact."""
    order = program.build_dfg().topo_order()
    slot = {nid: i for i, nid in enumerate(order)}
    op_of = {n.id: n.op for n in program.nodes}
    carry_slot: Dict[int, int] = {}
    inits: Dict[int, int] = {}
    for c in program.carries:
        if c.update is None:
            raise ValueError(f"{program.name}: carry {c.name} never set")
        carry_slot.setdefault(c.update, len(carry_slot))
        inits[c.update] = _int32(program, f"carry {c.name} init", c.init)

    def operand(nid: int, x) -> Tuple[int, int]:
        if x is None:
            return NONE, 0
        if isinstance(x, Val):
            return VAL, slot[x.node]
        if isinstance(x, Carry):
            return CARRY, carry_slot[x.update]
        return INT, _int32(program, f"node {nid} constant", int(x))

    rows = []
    for nid in order:
        op = op_of[nid]
        if op not in _OP_CLASS:
            raise ValueError(f"no ALU semantics for {op}")
        a, b = program.node_srcs[nid]
        flags = ((A_TAKES_IMM if op not in ("LWI", "SWI") else 0)
                 | (ADDRESS_ADDS_IMM if op in ("LWI", "SWI") else 0))
        producer = -1
        if op in ("BSFA", "BZFA"):
            if nid not in program.flag_deps:
                raise ValueError(f"{program.name}: node {nid} ({op}) has no "
                                 f"flag producer")
            producer = slot[program.flag_deps[nid]]
        imm = _int32(program, f"node {nid} immediate", program.node_imm[nid])
        rows.append([_OP_CLASS[op], *operand(nid, a), *operand(nid, b), imm,
                     flags, producer])
    updates = list(carry_slot)
    return OracleTable(
        name=program.name, trip=int(program.trip), node_ids=tuple(order),
        ops=tuple(op_of[n] for n in order),
        nodes=np.asarray(rows, np.int32).reshape(len(order), RECORD),
        carry_update=np.asarray([slot[u] for u in updates], np.int32),
        carry_init=np.asarray([inits[u] for u in updates], np.int32))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int64 holding the signed-32-bit-wrapped value."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _alu(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``engine._alu_vec`` on int64 tensors of int32 values."""
    shift = b & 31
    if op == ADD:
        return _wrap(a + b)
    if op == SUB:
        return _wrap(a - b)
    if op == MUL:
        return _wrap(a * b)
    if op == FXPMUL:
        return _wrap((a * b) >> FXP_FRAC_BITS)
    if op == SHL:
        return _wrap(a << shift)
    if op == SHR_LOGICAL:
        return _wrap((a & _M32) >> shift)
    if op == SHR_ARITH:
        return a >> shift
    if op == AND:
        return a & b
    if op == OR:
        return a | b
    if op == XOR:
        return a ^ b
    if op == NAND:
        return ~(a & b)
    if op == NOR:
        return ~(a | b)
    if op == XNOR:
        return ~(a ^ b)
    return torch.zeros_like(a)      # ZERO


def _interpret(table: OracleTable, mems: torch.Tensor
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The plain PyTorch interpreter of ``table`` over a (B, M) integer
    tensor, in int64 on its device: every node of every iteration over the
    whole batch, in the table's order.  Returns the last iteration's (B,)
    value of each slot and the final (B, M) images."""
    img = _wrap(mems.to(torch.int64)).clone()
    B, M = img.shape
    rows = torch.arange(B, device=img.device)

    def full(v: int) -> torch.Tensor:
        return torch.full((B,), v, dtype=torch.int64, device=img.device)

    carry = [full(int(v)) for v in table.carry_init]
    vals = [full(0)] * len(table.node_ids)
    for it in range(table.trip):
        for pos, rec in enumerate(table.nodes.tolist()):
            op, a_kind, a_arg, b_kind, b_arg, imm, flags, producer = rec

            def fetch(kind, arg, absent):
                if kind == NONE:
                    return full(absent)
                if kind == INT:
                    return full(arg)
                return vals[arg] if kind == VAL else carry[arg]

            a = fetch(a_kind, a_arg, imm if flags & A_TAKES_IMM else 0)
            b = fetch(b_kind, b_arg, imm)
            if op in (LOAD, STORE):
                addr = a + (imm if flags & ADDRESS_ADDS_IMM else 0)
                if bool(((addr < 0) | (addr >= M)).any()):
                    raise table.address_error(it * len(vals) + pos, M)
                if op == LOAD:
                    out = img[rows, addr]
                else:
                    out = b
                    img[rows, addr] = b
            elif op in (SELECT_SIGN, SELECT_ZERO):
                flag = vals[producer] < 0 if op == SELECT_SIGN \
                    else vals[producer] == 0
                out = torch.where(flag, a, b)
            else:
                out = _alu(op, a, b)
            vals[pos] = out
        carry = [vals[u] for u in table.carry_update.tolist()]
    return vals, img


def oracle_ref(table: OracleTable, mems: torch.Tensor
               ) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
    """The oracle of ``table`` over ``mems`` (B, M) in plain PyTorch, on
    their device: ``({nid: (B,) int64}, (B, M) int64)`` in host numpy, as
    ``fuzz.engine.batched_oracle`` returns them (no node values when the
    trip is 0)."""
    vals, img = _interpret(table, mems)
    node_vals = ({nid: vals[pos].cpu().numpy()
                  for pos, nid in enumerate(table.node_ids)}
                 if table.trip > 0 else {})
    return node_vals, img.cpu().numpy()


class OracleVerdict(NamedTuple):
    """What :func:`oracle_verdict` returns.  ``bad`` is on the host; the
    oracle's results stay on the operands' device, for the rows a caller
    asks about."""

    bad: np.ndarray        # (B,) bool: the memory's result differs
    image: torch.Tensor    # (B, M) int64, the oracle's final images
    vals: torch.Tensor     # (N, B) int64, last-iteration value a slot


def _slot_list(table: OracleTable, sim_vals: torch.Tensor,
               sim_slots: Sequence[int]) -> Tuple[int, ...]:
    """``sim_slots`` checked against ``sim_vals`` (K, B) and the table;
    none where the trip is 0, whose oracle has no node values."""
    slots = tuple(int(s) for s in sim_slots)
    if sim_vals.dim() != 2 or sim_vals.shape[0] != len(slots):
        raise ValueError(f"sim_vals: expected ({len(slots)}, B) for "
                         f"{len(slots)} slots, got {tuple(sim_vals.shape)}")
    N = len(table.node_ids)
    if any(not 0 <= s < N for s in slots):
        raise ValueError(f"sim_slots: a slot outside [0, {N})")
    return slots if table.trip > 0 else ()


def oracle_verdict_ref(table: OracleTable, mems: torch.Tensor,
                       sim_image: torch.Tensor, sim_vals: torch.Tensor,
                       sim_slots: Sequence[int]) -> OracleVerdict:
    """The plain version of :func:`oracle_verdict`, on ``mems``' device:
    :func:`oracle_ref`'s interpreter, then each memory's low 32 bits
    compared with the simulator's, as ``fuzz.engine.compare_batch``
    compares them."""
    slots = _slot_list(table, sim_vals, sim_slots)
    vals, img = _interpret(table, mems)
    sim_vals = sim_vals.to(img.device, torch.int64) & _M32
    bad = ((sim_image.to(img.device, torch.int64) & _M32)
           != (img & _M32)).any(dim=1)
    for k, slot in enumerate(slots):
        bad |= sim_vals[k] != (vals[slot] & _M32)
    N, B = len(vals), img.shape[0]
    per_slot = (torch.stack(vals) if N else
                torch.empty((0, B), dtype=torch.int64, device=img.device))
    return OracleVerdict(bad.cpu().numpy(), img, per_slot)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def oracle_geometry(N: int, C: int, M: int) -> Tuple[int, int, int]:
    """(threads a block, dynamic shared bytes, image in shared memory) of a
    launch over a table of N nodes and C carries and M-word memories.

    A block of T = ``THREADS`` memories holds the table, the node values
    and carries ``[slot][T]`` and the images word-major, ``[word][T + 1]``.
    Where that does not fit in 227 KB (M above about 1,700 words), the
    images stay in the output buffer in device memory.  Raises where the
    table and values alone pass 227 KB."""
    def shared(T: int, image: bool) -> int:
        return 4 * (RECORD * N + 2 * C + (N + C) * T
                    + (M * (T + 1) if image else 0))

    T = THREADS
    image = shared(T, True) <= MAX_SHARED_BYTES
    if T * M >= 1 << 31:
        raise ValueError(f"{M} memory words: a block's {T} images take 2^31 "
                         f"words or more")
    if shared(T, image) > MAX_SHARED_BYTES:
        raise ValueError(f"{N} nodes and {C} carries need "
                         f"{shared(T, image)} bytes of shared memory a block, "
                         f"above the {MAX_SHARED_BYTES} (227 KB) it may have")
    return T, shared(T, image), int(image)


def _check_operand(what: str, x: torch.Tensor, device: torch.device,
                   shape: Tuple[int, int]) -> None:
    if x.dtype != torch.int32 or tuple(x.shape) != shape \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{what}: expected a contiguous {shape} int32 "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def enqueue(table: OracleTable, mems: torch.Tensor, sim_image: torch.Tensor,
            sim_vals: torch.Tensor, sim_slots: Sequence[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``oracle_kernel`` launch of :func:`oracle_verdict`, not waited
    for.  Returns the device buffer (the oracle's images, then its node
    values) and the verdict words followed by the error word, both set
    for an empty batch without a launch.  ``oracle_verdict.launches``
    counts the launches."""
    device = mems.device
    if device.type != "cuda":
        raise ValueError(f"oracle_verdict runs on a CUDA device, not "
                         f"{device}; oracle_verdict_ref is its plain version")
    if mems.dtype != torch.int32 or mems.dim() != 2 \
            or not mems.is_contiguous():
        raise ValueError(f"mems: expected a contiguous (B, M) int32 tensor, "
                         f"got {mems.dtype} {tuple(mems.shape)}")
    B, M = mems.shape
    N, C = table.nodes.shape[0], table.carry_update.shape[0]
    threads, shared, image = oracle_geometry(N, C, M)
    slots = _slot_list(table, sim_vals, sim_slots)
    if not slots:
        sim_vals = sim_vals[:0]
    _check_operand("sim_image", sim_image, device, (B, M))
    _check_operand("sim_vals", sim_vals, device, (len(slots), B))
    out = torch.empty(B * M + N * B, dtype=torch.int64, device=device)
    pad = B + (B & 1)
    words = torch.empty(pad + 2, dtype=torch.int32, device=device)
    if not B:
        words[pad:] = NO_ERROR
        return out, words
    status = build.oracle_library().oracle_verdict_run(
        table.on_device(device).data_ptr(), mems.data_ptr(), out.data_ptr(),
        sim_image.data_ptr(), sim_vals.data_ptr(),
        table.slots_on_device(slots, device).data_ptr(), words.data_ptr(),
        len(slots), N, C, table.trip, B, M, threads, shared, image,
        _stream(device))
    if status != 0:
        raise RuntimeError(f"oracle launch failed: cudaError {status}")
    oracle_verdict.launches += 1
    return out, words


def oracle_verdict(table: OracleTable, mems: torch.Tensor,
                   sim_image: torch.Tensor, sim_vals: torch.Tensor,
                   sim_slots: Sequence[int]) -> OracleVerdict:
    """The oracle of ``table`` over ``mems``, a contiguous (B, M) int32
    tensor on a CUDA device, with the simulator's result compared on the
    card: ``sim_image`` (B, M) int32, its final images, and ``sim_vals``
    (K, B) int32, its last-iteration values of the nodes at table slots
    ``sim_slots``, both contiguous on ``mems``' device.  A memory is bad
    where an image word or one of those node values differs from the
    oracle's in its low 32 bits, as in ``fuzz.engine.compare_batch``;
    where the trip is 0 only the images are compared, as the oracle has
    no node values then.

    One launch, one copy of the (B,) verdict words and the error word
    into pinned host memory and one wait; the oracle's images and
    last-iteration node values (int32 values in int64) stay on the device,
    in the returned :class:`OracleVerdict`.  An address outside ``[0, M)``
    raises the numpy oracle's ``IndexError`` for the first such access in
    (iteration, node order).  There is no fallback:
    :func:`oracle_verdict_ref` is the plain version."""
    out, words = enqueue(table, mems, sim_image, sim_vals, sim_slots)
    B, M = mems.shape
    N = table.nodes.shape[0]
    host = torch.empty(words.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(words, non_blocking=True)
    torch.cuda.current_stream(mems.device).synchronize()
    flat = host.numpy()
    pad = B + (B & 1)
    error = int(flat[pad:].view(np.int64)[0])
    if error != NO_ERROR:
        raise table.address_error(error, M)
    return OracleVerdict(flat[:B] != 0, out[:B * M].view(B, M),
                         out[B * M:].view(N, B))


oracle_verdict.launches = 0
