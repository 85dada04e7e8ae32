"""The check sees a broken timed path, and its control, on the CPU.

Each test drives the rest of a run (set-up, the window, the reference's
check) past the harness's look for a card, at a size a test run holds,
with a fault planted in the program underneath; ``correct`` must come out
false.  The cells run on one card, so no exchange between cards exists to
leave out."""
import sys

import pytest
import repro_torch.cgra.simulator as simulator
import repro_torch.fuzz.engine as engine
from repro_torch.kernels.ref import PEState
from portbench.harness import control, result, spec

SEED = 2 ** 31 + 29


def _cell(name, kernels, memories=32, batch=16):
    cell = spec.load_cell(name)
    keep = [cell.config["kernels"].index(k) for k in kernels]
    cell.docs = [cell.docs[i] for i in keep]
    cell.config = dict(cell.config, kernels=list(kernels))
    cell.traffic = dict(cell.traffic, memories_per_call=memories,
                        batch=batch, check_calls=len(kernels))
    return cell


def _run(cell):
    line, numbers = result.run_once(cell, SEED, 0.0, False, "cpu")
    return line, {k: v for k, (v, _) in numbers.items()}


def _fuzz_cell():
    return _cell("fuzz-4x4-b16384", ("gsm", "dotprod"))


def test_a_sound_run_is_correct():
    line, nums = _run(_fuzz_cell())
    assert line["correct"] and not any(nums.values())


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    def unchanged(fields, state, neighbors, device="cuda", trace=True):
        T = fields.op.shape[0]
        return state, state.out[None].expand(T, *state.out.shape).clone()

    monkeypatch.setattr(simulator, "run_program", unchanged)
    line, nums = _run(_fuzz_cell())
    assert not line["correct"] and nums["verdict_diff"] > 0


def test_half_of_the_batch_left_out(monkeypatch):
    real = engine.execute_asm

    def half(asm, grid, mem, batch=1, device="cuda"):
        keep = max(1, batch // 2)
        final, outs, out0 = real(asm, grid, mem[:keep], batch=keep,
                                 device=device)
        reps = -(-batch // keep)
        final = PEState(*(t.repeat(reps, *([1] * (t.dim() - 1)))[:batch]
                          for t in final))
        return final, outs.repeat(1, reps, 1)[:, :batch], out0

    monkeypatch.setattr(engine, "execute_asm", half)
    line, nums = _run(_fuzz_cell())
    assert not line["correct"]
    assert nums["verdict_diff"] > 0 or nums["activity_diff"] > 0


@pytest.mark.parametrize("where", ["final_memory", "trace"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, where):
    real = simulator.run_program

    def altered(fields, state, neighbors, device="cuda", trace=True):
        final, outs = real(fields, state, neighbors, device, trace)
        if where == "final_memory":
            mem = final.mem.clone()
            mem[0, 0] += 1
            return final._replace(mem=mem), outs
        outs = outs.clone()
        t, p = (fields.op != 0).nonzero()[0].tolist()
        outs[t, 0, p] ^= 1 << 30
        return final, outs

    monkeypatch.setattr(simulator, "run_program", altered)
    line, nums = _run(_fuzz_cell())
    assert not line["correct"]
    assert nums["verdict_diff" if where == "final_memory"
                else "activity_diff"] > 0


@pytest.mark.parametrize("kernels", [
    ("gsm", "popcount", "stringsearch"), ("dotprod", "xorshift32")])
def test_the_control_is_not_correct(monkeypatch, kernels):
    """The reference with float32 arithmetic in the program's place; it
    runs where the program cannot be imported."""
    monkeypatch.setitem(sys.modules, "repro_torch.cgra.artifact", None)
    monkeypatch.setitem(sys.modules, "repro_torch.fuzz.engine", None)
    cell = _cell("fuzz-4x4-b16384", kernels, memories=200, batch=64)
    got = control.run_control(cell, SEED)
    assert not got["correct"]
    assert got["numbers"]["verdict_diff"] > 0
    assert got["numbers"]["activity_diff"] > 0
