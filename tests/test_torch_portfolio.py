"""The port's portfolio racer against the JAX package's: ``RaceBook``
decisions after every event of the same sequences (every order of the
exhaustive order-independence case, the named cases and seeded random
sequences), the race payload and its outcome JSON, the registry's
equivalence cases at ``jobs=1`` with ``MapResult`` equal to the JAX
package's, a real race on two worker processes, a chaos-crashed racing
worker, facts feeding a race, and the ``map`` verb's ``--strategy``,
``--jobs`` and ``--cache-dir``.  Everything races CDCL strategies on the
CPU (``tests/test_portfolio.py`` does the same).
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch", reason="optional extra: pip install .[torch]")
pytest.importorskip("jax", reason="optional extra: pip install .[jax]")

from repro.core import MapperConfig as JaxConfig  # noqa: E402
from repro.core import backends as jax_backends  # noqa: E402
from repro.core import facts as jax_facts  # noqa: E402
from repro.core import portfolio as jax_portfolio  # noqa: E402
from repro.core.mapper import IIOutcome as JaxOutcome  # noqa: E402
from repro.toolchain import Toolchain as JaxToolchain  # noqa: E402
from repro.toolchain import cli as jax_cli  # noqa: E402
from repro_torch.core import MapperConfig, backends, facts  # noqa: E402
from repro_torch.core import portfolio, validate_mapping  # noqa: E402
from repro_torch.core.mapper import IIOutcome  # noqa: E402
from repro_torch.toolchain import Toolchain  # noqa: E402
from repro_torch.toolchain import cli  # noqa: E402
from repro_torch.toolchain.chaos import ENV_KEY, ChaosSpec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CDCL = dict(backend="cdcl", per_ii_timeout_s=10.0, total_timeout_s=30.0)
PORTFOLIO = "portfolio:cdcl-seq+cdcl-pair,spec_ii=2"
#: ``tests/test_portfolio.py``'s fast (kernel, grid) points, spanning both
#: registry origins
EQUIV_CASES = [
    ("bitcount", (2, 2)),
    ("reversebits", (2, 2)),
    ("dotprod", (3, 3)),
    ("saxpy", (2, 2)),
    ("relu_clamp", (2, 2)),
    ("xorshift32", (3, 3)),
    ("gsm", (2, 2)),
    ("prefix_sum", (3, 3)),
    ("popcount", (3, 3)),
]
#: MapResult fields measured on the wall clock
_TIMED = ("total_time_s", "time_s", "encode_time_s", "cancelled_after_s",
          "map_time_s")


def _untimed(doc):
    if isinstance(doc, dict):
        return {k: _untimed(v) for k, v in doc.items() if k not in _TIMED}
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


def _portfolio_cfg(cls, strategy=PORTFOLIO):
    return cls(strategy=strategy, per_ii_timeout_s=10.0,
               total_timeout_s=30.0)


# ---------------------------------------------------------------------------
# RaceBook: equal decisions after every event
# ---------------------------------------------------------------------------

SPEC2 = backends.parse_portfolio(PORTFOLIO)
J_SPEC2 = jax_backends.parse_portfolio(PORTFOLIO)
SPEC3 = backends.parse_portfolio("portfolio:cdcl-seq+cdcl-pair,spec_ii=3")
J_SPEC3 = jax_backends.parse_portfolio(
    "portfolio:cdcl-seq+cdcl-pair,spec_ii=3")


def _outcome(cls, ii, verdict, proven=False):
    mapping = SimpleNamespace(ii=ii) if verdict == "mapped" else None
    return cls(ii=ii, verdict=verdict, mapping=mapping, proven_unsat=proven)


def _state(book):
    return (book.resolution(), dict(book.decided), book.window(),
            book.wanted(), sorted(book.completed), sorted(book.lost),
            {ii: sidx for ii, (sidx, _) in book.mapped.items()},
            book.needs_inline(), [book.moot(ii) for ii in range(2, 12)])


def _replay(events, start=3, ii_max=10, known_unsat=(), spec=2):
    """Feed one event list to both packages' books; the full decision
    state after every event must agree.  Returns the final resolution."""
    book = portfolio.RaceBook(SPEC2 if spec == 2 else SPEC3, start, ii_max,
                              known_unsat=known_unsat)
    j_book = jax_portfolio.RaceBook(J_SPEC2 if spec == 2 else J_SPEC3,
                                    start, ii_max, known_unsat=known_unsat)
    assert _state(book) == _state(j_book)
    for ev in events:
        if ev[0] == "lost":
            book.record_lost(ev[1], ev[2])
            j_book.record_lost(ev[1], ev[2])
        else:
            ii, sidx, verdict, proven = ev
            book.record(ii, sidx, _outcome(IIOutcome, ii, verdict, proven))
            j_book.record(ii, sidx, _outcome(JaxOutcome, ii, verdict, proven))
        assert _state(book) == _state(j_book), ev
    return book.resolution()


def test_racebook_every_order_of_the_exhaustive_case_matches_jax():
    events = [(3, 0, "advance", False), (3, 1, "advance", True),
              (4, 0, "mapped", False), (4, 1, "mapped", False)]
    resolutions = {_replay([events[i] for i in order])
                   for order in itertools.permutations(range(4))}
    assert resolutions == {("mapped", 4)}


@pytest.mark.parametrize("events,kw,want", [
    # speculative II+1 waits for the lower rung
    ([(4, 0, "mapped", False), (3, 0, "advance", False)], {}, ("mapped", 4)),
    # a lower-rung mapping beats an earlier higher win
    ([(4, 0, "mapped", False), (3, 0, "mapped", False)], {}, ("mapped", 3)),
    # a non-primary mapped is telemetry only
    ([(3, 1, "mapped", False), (3, 0, "advance", False),
      (4, 0, "mapped", False)], {}, ("mapped", 4)),
    # a proven UNSAT from any strategy decides
    ([(3, 1, "advance", True), (4, 0, "mapped", False)], {}, ("mapped", 4)),
    # interrupted keeps the rung open
    ([(3, 0, "interrupted", False)], {}, None),
    # lifted UNSAT rungs pre-decide, the window skips them
    ([(5, 0, "mapped", False)], {"known_unsat": (3, 4)}, ("mapped", 5)),
    # a primary loss settles on the lowest-index survivor
    ([("lost", 3, 0), (3, 1, "mapped", False)], {}, ("mapped", 3)),
    # every strategy lost: the parent must solve the rung inline
    ([("lost", 3, 0), ("lost", 3, 1)], {}, None),
    # the ladder runs out
    ([(3, 0, "advance", False), (4, 0, "advance", False)], {"ii_max": 4},
     ("unsat-capped", None)),
    # a primary timeout ends the race
    ([(3, 0, "timeout", False)], {}, ("timeout", None)),
])
def test_racebook_named_cases_match_jax(events, kw, want):
    assert _replay(events, **kw) == want


@pytest.mark.parametrize("seed", range(8))
def test_racebook_random_sequences_match_jax(seed):
    """Seeded random, realizable event streams over a three-rung window:
    per II one ground truth (SAT or UNSAT), strategies answering it in
    any order, with interrupts and losses mixed in."""
    rng = np.random.RandomState(seed)
    start, ii_max = 3, 9
    feasible_from = int(rng.randint(start, ii_max + 2))
    events = []
    for ii in range(start, ii_max + 1):
        for sidx in range(2):
            r = rng.rand()
            if r < 0.15:
                events.append(("lost", ii, sidx))
            elif r < 0.3:
                events.append((ii, sidx, "interrupted", False))
            elif ii >= feasible_from:
                events.append((ii, sidx, "mapped", False))
            else:
                proven = bool(rng.randint(0, 2))
                events.append((ii, sidx, "advance", proven))
    order = rng.permutation(len(events))
    _replay([events[i] for i in order], start=start, ii_max=ii_max, spec=3)


# ---------------------------------------------------------------------------
# the worker-side payload and its outcome JSON
# ---------------------------------------------------------------------------


def test_race_payload_outcome_matches_jax():
    """One (II, strategy) attempt through the worker entry point, run in
    this process: the outcome JSON equals the JAX package's and survives
    the round trip."""
    from repro_torch.cgra import make_grid

    payload = {"kind": "race-ii", "kernel": "gsm", "dfg": None,
               "grid": make_grid(2, 2),
               "cfg": dataclasses.asdict(MapperConfig(**CDCL)),
               "oracle": "assembler", "ii": 5, "strategy": "cdcl-pair",
               "blocked": [], "attempt": 0}
    from repro.cgra import make_grid as jax_make_grid

    j_payload = dict(payload, grid=jax_make_grid(2, 2),
                     cfg=dataclasses.asdict(JaxConfig(**CDCL)))
    out = portfolio.run_race_payload(payload, inline=True)
    want = jax_portfolio.run_race_payload(j_payload, inline=True)
    assert out.keys() == want.keys() == {"outcome", "map_time_s"}
    assert _untimed(out["outcome"]) == _untimed(want["outcome"])
    assert out["outcome"]["verdict"] == "mapped"
    tc = Toolchain((2, 2), MapperConfig(**CDCL))
    dfg = tc.program("gsm").dfg
    again = portfolio._outcome_to_jsonable(portfolio._outcome_from_jsonable(
        dfg, tc.grid, out["outcome"]))
    assert again == out["outcome"]


def test_race_payload_failure_is_structured():
    from repro_torch.cgra import make_grid

    payload = {"kind": "race-ii", "kernel": "no-such-kernel", "dfg": None,
               "grid": make_grid(2, 2),
               "cfg": dataclasses.asdict(MapperConfig(**CDCL)),
               "oracle": None, "ii": 2, "strategy": "cdcl-seq",
               "blocked": [], "attempt": 1}
    out = portfolio.run_race_payload(payload, inline=True)
    assert out["failure"]["kind"] == "solver-error"
    assert out["failure"]["stage"] == "race" and out["failure"]["attempt"] == 1


# ---------------------------------------------------------------------------
# portfolio == sequential II, and == the JAX racer at jobs=1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,size", EQUIV_CASES,
                         ids=[f"{k}@{r}x{c}" for k, (r, c) in EQUIV_CASES])
def test_portfolio_jobs1_matches_jax(kernel, size):
    port = Toolchain(size, _portfolio_cfg(MapperConfig)).map(kernel, jobs=1)
    want = JaxToolchain(size, _portfolio_cfg(JaxConfig)).map(kernel, jobs=1)
    seq = Toolchain(size, MapperConfig(**CDCL)).map(kernel)
    assert port.status == want.status == seq.status == "mapped"
    assert port.ii == seq.ii
    assert _untimed(port.to_dict()) == _untimed(want.to_dict())
    assert not port.validation_errors and port.winner
    assert port.strategies_raced >= 1


def test_portfolio_fleet_race_matches_sequential():
    seq = Toolchain((2, 2), MapperConfig(**CDCL)).map("gsm")
    port = Toolchain((2, 2), _portfolio_cfg(MapperConfig)).map("gsm", jobs=2)
    assert port.status == "mapped" and port.ii == seq.ii
    assert validate_mapping(port.mapping) == []
    assert port.winner in ("cdcl-seq", "cdcl-pair")
    assert port.strategies_raced >= 2


def test_chaos_crashed_racing_worker_heals(monkeypatch):
    seq = Toolchain((2, 2), MapperConfig(**CDCL)).map("gsm")
    spec = ChaosSpec(seed=11, rate=1.0, kinds=("crash",), attempts=(0,))
    monkeypatch.setenv(ENV_KEY, spec.to_json())
    port = Toolchain((2, 2), _portfolio_cfg(MapperConfig)).map("gsm", jobs=2)
    assert port.status == "mapped"
    assert port.ii == seq.ii
    assert validate_mapping(port.mapping) == []


def test_facts_seed_a_race_as_in_jax():
    """Facts lifted from mesh-2x2 seed the mesh-3x3 race: the in-process
    race consumes them as the JAX racer does."""
    store, j_store = facts.FactStore(), jax_facts.FactStore()
    Toolchain("mesh-2x2", MapperConfig(**CDCL), facts=store).map("gsm")
    JaxToolchain("mesh-2x2", JaxConfig(**CDCL), facts=j_store).map("gsm")
    port = Toolchain("mesh-3x3", _portfolio_cfg(MapperConfig),
                     facts=store).map("gsm", jobs=1)
    want = JaxToolchain("mesh-3x3", _portfolio_cfg(JaxConfig),
                        facts=j_store).map("gsm", jobs=1)
    assert port.facts_used == want.facts_used >= 2
    assert _untimed(port.to_dict()) == _untimed(want.to_dict())
    assert store.stats() == j_store.stats()


# ---------------------------------------------------------------------------
# the map verb
# ---------------------------------------------------------------------------


def _digest_without_timings(doc):
    for key in ("wall_time_s", "stage_times_s", "map_time_s",
                "cancelled_after_s"):
        doc.pop(key, None)
    return doc


def test_map_verb_strategy_jobs_cache_dir_digest_matches_jax(tmp_path,
                                                             capsys):
    """``python -m repro_torch map gsm --strategy ... --jobs 1 --cache-dir
    D --json`` prints the digest of ``python -m repro map``, bar the
    timings, cold and then from the cache; the two packages' cache
    directories hold the same entries."""
    argv = ["gsm", "--grid", "2x2", "--backend", "auto", "--strategy",
            PORTFOLIO, "--jobs", "1", "--json"]
    docs = {}
    for name in ("port", "jax"):
        cache_dir = str(tmp_path / name)
        runs = []
        for _ in range(2):
            if name == "port":
                proc = subprocess.run(
                    [sys.executable, "-m", "repro_torch", "map", *argv,
                     "--cache-dir", cache_dir], capture_output=True,
                    text=True, cwd=ROOT, timeout=120,
                    env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
                assert proc.returncode == 0, proc.stderr
                runs.append(json.loads(proc.stdout))
            else:
                assert jax_cli.main(["map", *argv, "--cache-dir",
                                     cache_dir]) == 0
                runs.append(json.loads(capsys.readouterr().out))
        docs[name] = [_digest_without_timings(d) for d in runs]
    assert docs["port"] == docs["jax"]
    cold, warm = docs["port"]
    assert (cold["cache_hit"], warm["cache_hit"]) == (False, True)
    assert cold["status"] == "ok" and cold["strategies_raced"] >= 1
    assert cold["winner"] == "cdcl-seq"
    entries = [sorted(p.name for p in (tmp_path / n).rglob("*.json"))
               for n in ("port", "jax")]
    assert entries[0] == entries[1] and len(entries[0]) == 1


def test_sequential_digest_has_no_portfolio_fields(capsys):
    assert cli.main(["bitcount", "--grid", "2x2", "--backend", "cdcl",
                     "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    for key in ("strategies_raced", "winner", "cancelled_after_s",
                "facts_used"):
        assert key not in doc


def test_map_verb_strategy_backend_conflict_fails_as_jax(capsys):
    argv = ["bitcount", "--grid", "2x2", "--backend", "cdcl", "--strategy",
            "cdcl-seq"]
    rc = cli.main(argv)
    port = capsys.readouterr().out
    assert rc == jax_cli.main(["map", *argv]) == 1
    assert port == capsys.readouterr().out
    assert "conflicts with backend='cdcl'" in port
