"""repro_torch simulate/verify on every shipped artifact against the JAX
package's simulator, and the neighbour wiring of torus and mesh grids.

Both packages execute the same bitstream over the same memories on the
CPU; outs, initial OUT and every final state field must be equal.
"""
import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.archspec import parse_arch  # noqa: E402
from repro.cgra import make_grid  # noqa: E402
from repro.cgra import simulator as jax_sim  # noqa: E402
from repro_torch.cgra.arch import Grid, neighbor_table  # noqa: E402
from repro_torch.cgra.artifact import load_artifact  # noqa: E402
from repro_torch.cgra.simulator import execute_asm, simulate, verify  # noqa: E402
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from torch_parity import SHIPPED, jax_asm, jax_grid  # noqa: E402

STATE = ("regs", "out", "sf", "zf", "mem")


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_execute_asm_matches_jax(arch, kernel):
    art = load_artifact(arch, kernel)
    mems = make_corpus(art, 10, seed=5)
    final, outs, out0 = execute_asm(art.asm, art.grid, mems, batch=10,
                                    device="cpu")
    j_final, j_outs, j_out0 = jax_sim.execute_asm(
        jax_asm(art.asm), jax_grid(art), mems, batch=10)
    np.testing.assert_array_equal(outs.numpy(), j_outs)
    np.testing.assert_array_equal(out0.numpy(), j_out0)
    for name, a, b in zip(STATE, final, j_final):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert art.asm.op_counts() == jax_asm(art.asm).op_counts()


@pytest.mark.parametrize("arch,kernel", SHIPPED)
def test_verify_passes_on_seeded_memories(arch, kernel):
    art = load_artifact(arch, kernel)
    for seed in range(4):
        mem = make_corpus(art, 1, seed=seed)[0]
        assert verify(art, mem, device="cpu") == []


def test_verify_reports_a_wrong_bitstream():
    art = load_artifact("4x4", "dotprod")
    (t, pe), _ = next(iter(art.asm.node_of_cell.items()))
    art.asm.bitstream = art.asm.bitstream.copy()
    art.asm.bitstream[t, pe] ^= 1 << 27          # flip the opcode's low bit
    errors = verify(art, make_corpus(art, 1)[0], device="cpu")
    assert errors and all("!= oracle" in e for e in errors)


def test_simulate_node_values_are_last_iteration():
    art = load_artifact("4x4", "bitcount")
    mem = make_corpus(art, 1)[0]
    sim = simulate(art, mem, batch=3, device="cpu")
    want = art.program.last_iteration_values([int(v) for v in mem])
    assert sim.total_rows == art.asm.total_rows
    assert sim.final_mem.shape == (3, mem.shape[0])
    for n, vals in sim.node_values.items():
        assert [int(v) for v in vals] == [want[n]] * 3


@pytest.mark.parametrize("topology", ["torus", "mesh"])
@pytest.mark.parametrize("side", [2, 3, 4, 5, 6])
def test_neighbor_table_matches_jax(topology, side):
    want = jax_sim.neighbor_table(make_grid(side, side,
                                            torus=topology == "torus"))
    assert neighbor_table(Grid(side, side, topology)) == want


@pytest.mark.parametrize("preset", ["adres-4x4", "mesh-4x4", "4x4"])
def test_neighbor_table_matches_jax_presets(preset):
    grid = parse_arch(preset).grid()
    port = Grid(grid.spec.rows, grid.spec.cols,
                grid.spec.resolved_topology())
    assert neighbor_table(port) == jax_sim.neighbor_table(grid)


def test_mesh_edges_wire_to_self():
    table = neighbor_table(Grid(4, 4, "mesh"))
    assert table[0] == (0, 1, 4, 0)          # N and W are off the grid
    assert table[15] == (11, 15, 15, 14)     # E and S are off the grid
    assert neighbor_table(Grid(4, 4, "torus"))[0] == (12, 1, 4, 3)
