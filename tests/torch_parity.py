"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the JAX
package's view of a ``repro_torch`` mapped-kernel artifact."""
from repro.cgra.arch import CGRASpec, PEGrid
from repro.cgra.bitstream import AssembledCIL
from repro.cgra.isa import decode_program

#: (arch, kernel) of every shipped artifact
SHIPPED = [("4x4", k) for k in (
    "argmax", "bitcount", "dotprod", "ema_fxp", "fir4", "gsm", "popcount",
    "prefix_sum", "relu_clamp", "reversebits", "sad", "saxpy", "stencil3",
    "stringsearch", "xorshift32")] + [("3x3", "sqrt")]


def jax_grid(artifact) -> PEGrid:
    g = artifact.grid
    return PEGrid(CGRASpec(rows=g.rows, cols=g.cols,
                           torus=g.topology == "torus"))


def jax_asm(asm) -> AssembledCIL:
    """The JAX package's ``AssembledCIL`` for the port's one."""
    return AssembledCIL(
        name=asm.name, ii=asm.ii, num_pes=asm.num_pes, trip=asm.trip,
        rows=decode_program(asm.words()), prologue=[], kernel=[],
        epilogue=[], presets_out=dict(asm.presets_out),
        presets_reg=dict(asm.presets_reg),
        node_of_cell=dict(asm.node_of_cell))
