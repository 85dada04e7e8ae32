"""repro_torch simulate/verify on every shipped artifact against the JAX
package's simulator, the neighbour wiring of torus and mesh grids, and
the device program (words, presets and neighbour table built once a
bitstream; presets broadcast on the device; an image tensor used as it
is).

Both packages execute the same bitstream over the same memories on the
CPU; outs, initial OUT and every final state field must be equal.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch",
                            reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.archspec import parse_arch  # noqa: E402
from repro.cgra import make_grid  # noqa: E402
from repro.cgra import simulator as jax_sim  # noqa: E402
from repro_torch.cgra.arch import Grid, neighbor_table  # noqa: E402
from repro_torch.cgra.artifact import Artifact, load_artifact  # noqa: E402
from repro_torch.cgra.simulator import (  # noqa: E402
    device_neighbors, device_program, execute_asm, preset_arrays,
    preset_state, simulate, stacked_preset_state, verify)
from repro_torch.fuzz.corpus import make_corpus  # noqa: E402
from repro_torch.fuzz.triage import inject_fault  # noqa: E402
from repro_torch.kernels.ops import init_state, run_program  # noqa: E402
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


# ---------------------------------------------------------------------------
# the device program: words, presets and neighbour table built once a
# bitstream, the presets broadcast on the device, the image used as given
# ---------------------------------------------------------------------------

ADRES = sorted((Path(__file__).resolve().parents[1] / "portbench" / "data"
                / "adres-8x8").glob("*.json"))


def _adres(path):
    return Artifact.from_dict(json.loads(path.read_text()))


def _grouped():
    """The shipped 4x4 artifacts (P = 16) and the benchmark's 8x8 ones
    (P = 64), each group on one grid."""
    return {16: [load_artifact(a, k) for a, k in SHIPPED if a == "4x4"],
            64: [_adres(p) for p in ADRES]}


def _repeated(asm, P, B):
    out0, regs0 = preset_arrays(asm, P)
    return np.repeat(out0[None], B, 0), np.repeat(regs0[None], B, 0)


@pytest.mark.parametrize("P", [16, 64])
def test_preset_state_equals_a_host_repeat_of_the_preset_arrays(P):
    """The presets broadcast on the device equal ``np.repeat`` of
    :func:`preset_arrays` over the batch, alone and stacked; flags are 0
    and the images those sent."""
    arts = _grouped()[P]
    assert arts and all(a.grid.num_pes == P for a in arts)
    B = 5
    mems = np.stack([make_corpus(a, B, seed=2) for a in arts])
    for art, mem in zip(arts, mems):
        state = preset_state(art.asm, P, mem, B, device="cpu")
        out, regs = _repeated(art.asm, P, B)
        np.testing.assert_array_equal(state.out.numpy(), out)
        np.testing.assert_array_equal(state.regs.numpy(), regs)
        assert not state.sf.any() and not state.zf.any()
        np.testing.assert_array_equal(state.mem.numpy(), mem)
        assert all(t.dtype == torch.int32 and t.is_contiguous()
                   for t in state)
    stacked = stacked_preset_state([a.asm for a in arts], P, mems, "cpu")
    want = [_repeated(a.asm, P, B) for a in arts]
    np.testing.assert_array_equal(stacked.out.numpy(),
                                  np.stack([o for o, _ in want]))
    np.testing.assert_array_equal(stacked.regs.numpy(),
                                  np.stack([r for _, r in want]))
    assert tuple(stacked.sf.shape) == (len(arts), B, P)
    assert not stacked.sf.any() and not stacked.zf.any()
    np.testing.assert_array_equal(stacked.mem.numpy(), mems)


def test_init_state_uses_an_image_tensor_as_it_is():
    """A tensor on the device keeps its storage (one image is expanded,
    not copied); a host array is copied."""
    image = torch.arange(6 * 8, dtype=torch.int32).view(6, 8)
    state = init_state(6, 4, image, device="cpu")
    assert state.mem.data_ptr() == image.data_ptr()
    assert preset_state(load_artifact("4x4", "gsm").asm, 16, image, 6,
                        "cpu").mem.data_ptr() == image.data_ptr()
    one = init_state(6, 4, image[0], device="cpu").mem
    assert one.data_ptr() == image.data_ptr() and tuple(one.shape) == (6, 8)
    host = image.numpy().copy()
    copied = init_state(6, 4, host, device="cpu").mem
    assert copied.data_ptr() != host.ctypes.data
    np.testing.assert_array_equal(copied.numpy(), host)


def test_device_program_is_built_once_a_bitstream():
    """The second run of an asm builds nothing; a copy with other words
    (``dataclasses.replace``, as fault injection makes one) and words
    assigned to the asm are built anew, and run as their words say."""
    art = load_artifact("4x4", "dotprod")
    mems = make_corpus(art, 3, seed=1)
    before = device_program.builds
    first = execute_asm(art.asm, art.grid, mems, batch=3, device="cpu")
    assert device_program.builds == before + 1
    prog = device_program(art.asm, 16, "cpu")
    execute_asm(art.asm, art.grid, mems, batch=3, device="cpu")
    assert device_program(art.asm, 16, torch.device("cpu")) is prog
    assert device_program.builds == before + 1
    np.testing.assert_array_equal(prog.fields.op.numpy(),
                                  (art.asm.words() >> 27).astype(np.int32))

    faulted = inject_fault(art.asm)[0]
    other = execute_asm(faulted, art.grid, mems, batch=3, device="cpu")
    assert device_program.builds == before + 2
    assert device_program(faulted, 16, "cpu") is not prog
    assert not torch.equal(first[1], other[1])

    (t, pe), _ = next(iter(art.asm.node_of_cell.items()))
    art.asm.bitstream = art.asm.bitstream.copy()
    art.asm.bitstream[t, pe] ^= 1 << 27
    assert device_program(art.asm, 16, "cpu") is not prog
    assert device_program.builds == before + 3


def test_run_program_leaves_the_state_it_starts_from_unchanged():
    """The run returns fresh final tensors and leaves ``state``, the image
    the oracle then reads among them, as it was, with the neighbour table
    as a list or as the checked tensor."""
    art = load_artifact("4x4", "gsm")
    mems = make_corpus(art, 4, seed=7)
    image = torch.as_tensor(mems.copy())
    state = preset_state(art.asm, 16, image, 4, "cpu")
    kept = [t.clone() for t in state]
    fields = device_program(art.asm, 16, "cpu").fields
    by_table = run_program(fields, state, neighbor_table(art.grid), "cpu")
    by_tensor = run_program(fields, state, device_neighbors(art.grid, "cpu"),
                            "cpu")
    for a, b in zip(by_table[0], by_tensor[0]):
        assert torch.equal(a, b)
    assert torch.equal(by_table[1], by_tensor[1])
    for t, k in zip(state, kept):
        assert torch.equal(t, k)
    np.testing.assert_array_equal(image.numpy(), mems)
    assert by_tensor[0].mem.data_ptr() != image.data_ptr()
    assert device_neighbors(art.grid, "cpu") is device_neighbors(art.grid,
                                                                 "cpu")
    with pytest.raises(ValueError, match="neighbors"):
        run_program(fields, state, [(0, 0, 0, 0)] * 15 + [(16, 0, 0, 0)],
                    "cpu")
