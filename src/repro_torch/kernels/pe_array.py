"""The CGRA cycle step on the card: wrapper of the hand-written CUDA kernel
``csrc/pe_array.cu``, which replaces ``repro/kernels/pe_array.py``'s
Pallas ``_cycle_kernel``.

``cycle_step`` launches the kernel for CUDA tensors and raises if it
cannot.  CPU tensors go to the plain version, ``ref.cycle_step_ref``.
``cycle_step.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import InstrRow, PEState, cycle_step_ref


def _check(state: PEState, instr: InstrRow, neighbors: torch.Tensor,
           out: PEState) -> None:
    B, P = state.out.shape
    M = state.mem.shape[1]
    shapes = {"regs": (B, P, 4), "out": (B, P), "sf": (B, P),
              "zf": (B, P), "mem": (B, M)}
    device = state.out.device
    named = ([(f"state.{k}", t, shapes[k]) for k, t in state._asdict().items()]
             + [(f"out.{k}", t, shapes[k]) for k, t in out._asdict().items()]
             + [(f"instr.{k}", t, (P,)) for k, t in instr._asdict().items()]
             + [("neighbors", neighbors, (P, 4))])
    for name, t, shape in named:
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    for src, dst in zip(state, out):
        if src.data_ptr() == dst.data_ptr():
            raise ValueError("output buffers must not alias the input state")
    if not 0 < P <= 256:
        raise ValueError(f"{P} PEs: the kernel takes 1 to 256")


def cycle_step(state: PEState, instr: InstrRow, neighbors: torch.Tensor,
               out: Optional[PEState] = None) -> PEState:
    """One CGRA cycle.  ``neighbors`` is the (P, 4) int32 N/E/S/W table on
    the state's device, every entry in ``[0, P)``.  The new state goes into
    ``out`` when given (buffers that must not alias ``state``), else into
    fresh tensors."""
    device = state.out.device
    if device.type == "cpu":
        new = cycle_step_ref(state, instr, neighbors)
        if out is None:
            return new
        for dst, src in zip(out, new):
            dst.copy_(src)
        return out
    if device.type != "cuda":
        raise ValueError(f"cycle_step runs on cuda or cpu, not {device}")
    if out is None:
        out = PEState(*(torch.empty_like(t) for t in state))
    _check(state, instr, neighbors, out)
    from .build import library

    B, P = state.out.shape
    M = state.mem.shape[1]
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = [t.data_ptr() for t in (*instr, neighbors, *state, *out)]
    status = library().pe_cycle_step(*ptrs, B, P, M, stream)
    if status != 0:
        raise RuntimeError(f"pe_cycle_step launch failed: cudaError {status}")
    cycle_step.launches += 1
    return out


cycle_step.launches = 0
