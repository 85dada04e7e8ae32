"""The compilation session: one staged pipeline from kernel to metrics.

A copy of the single-point half of ``src/repro/toolchain/session.py``.
:class:`Toolchain` binds an architecture, a :class:`MapperConfig` and a
CEGAR oracle, then exposes the paper's flow (Fig. 4) as explicit,
individually-inspectable stages::

    tc = Toolchain("4x4", MapperConfig(backend="cdcl"))
    prog = tc.program("dotprod")     # source  -> Program
    res = tc.map(prog)               # Program -> MapResult (SAT + CEGAR)
    asm = tc.assemble(prog, res.mapping)    # -> AssembledCIL
    m = tc.metrics(prog, res.mapping, asm)  # -> RuntimeMetrics
    sim = tc.simulate(prog, res.mapping, mem)  # on the card by default

``compile()`` runs the stages end-to-end into a :class:`CompileResult`
whose ``stage`` field names where a failing pipeline died.

Not ported yet (``ROADMAP.md``), and refused rather than ignored: the
mapping cache (``cache=``), the cross-point fact store (``facts=``), the
portfolio racer's ``jobs=`` and the resilient fleet behind
``compile_many``.

Sources accepted by the ``program`` stage: a registry kernel name, a
:class:`~repro_torch.cgra.programs.LoopBuilder`, a
:class:`~repro_torch.frontend.TracedKernel`, a bare
:class:`~repro_torch.core.dfg.DFG` (map-only), or an existing
:class:`Program`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from ..archspec import ArchSpec, parse_arch
from ..cgra.arch import PEGrid, make_grid
from ..cgra.bitstream import AssembledCIL, assemble
from ..cgra.energy import RuntimeMetrics, runtime_metrics
from ..core.dfg import DFG
from ..core.mapper import MapperConfig, MapResult, map_dfg
from ..core.mapping import Mapping
from ..obs import trace as obs_trace
from .artifacts import CompileResult, Program, StageError, format_error
from .oracles import assembler_oracle, resolve_oracle

ArchLike = Union[PEGrid, ArchSpec, str, Tuple[int, int]]


def resolve_arch(arch: ArchLike) -> PEGrid:
    """``PEGrid`` | ``ArchSpec`` | spec/preset string | ``(4, 4)`` ->
    :class:`PEGrid`.

    Strings go through :func:`repro_torch.archspec.parse_arch`, so ``"4x4"``
    still means the homogeneous torus while ``"mesh-4x4:mem=col0"`` or a
    preset name like ``"bordermem-4x4"`` yields a capability-annotated
    grid."""
    if isinstance(arch, PEGrid):
        return arch
    if isinstance(arch, ArchSpec):
        return arch.grid()
    if isinstance(arch, str):
        return parse_arch(arch).grid()
    rows, cols = arch
    return make_grid(int(rows), int(cols))


def arch_label(arch: ArchLike, grid: PEGrid) -> Optional[str]:
    """Display label for a non-default architecture, else ``None``.

    ``None`` keeps the homogeneous-torus digests (and their committed CI
    baselines) byte-identical; anything spec'd beyond ``RxC`` torus gets
    its canonical compact label into CLI/bench artifacts."""
    spec = None
    if isinstance(arch, ArchSpec):
        spec = arch
    elif isinstance(arch, str):
        spec = parse_arch(arch)
    if spec is not None:
        if spec.to_compact() != f"torus-{spec.rows}x{spec.cols}":
            return spec.label()
        return None
    # raw PEGrid: the capability selectors are not recoverable, so label
    # with name > topology-RxC, plus the content fingerprint when a
    # capability table makes two same-shape fabrics distinct
    fingerprint = grid.arch_fingerprint()
    if fingerprint is None and grid.spec.torus:
        return None
    if grid.spec.name:
        return grid.spec.name
    shape = (f"{grid.spec.resolved_topology()}-"
             f"{grid.spec.rows}x{grid.spec.cols}")
    if grid.caps is not None:
        return f"{shape}#{fingerprint[:8]}"
    return shape


class Toolchain:
    """A compilation session over one architecture + mapper config.

    ``oracle`` is ``"assembler"`` (default), ``None``, or a custom factory
    — see :mod:`repro_torch.toolchain.oracles`.  ``cache`` and ``facts``
    are the JAX package's mapping cache and fact store, not ported yet:
    anything but ``None`` raises.
    """

    def __init__(
        self,
        arch: ArchLike = "4x4",
        config: Optional[MapperConfig] = None,
        *,
        cache=None,
        oracle="assembler",
        facts=None,
    ):
        for name, value in (("cache", cache), ("facts", facts)):
            if value is not None:
                raise NotImplementedError(
                    f"Toolchain({name}=...) is not ported yet (ROADMAP.md)")
        self.grid = resolve_arch(arch)
        self.arch = arch_label(arch, self.grid)
        self.config = config or MapperConfig()
        self.oracle_tag, self._oracle_factory = resolve_oracle(oracle)

    # -- stage 1: source -> Program ----------------------------------------

    def program(self, source) -> Program:
        """Resolve any supported source into a :class:`Program`."""
        try:
            return self._resolve_program(source)
        except StageError:
            raise
        except Exception as e:
            raise StageError("source", format_error(e), cause=e) from e

    def _resolve_program(self, source) -> Program:
        if isinstance(source, Program):
            return source
        if isinstance(source, str):
            from ..cgra.registry import get_kernel

            spec = get_kernel(source)
            builder = spec.factory()
            return Program(
                name=source,
                origin=spec.origin,
                dfg=builder.build_dfg(),
                builder=builder,
                make_mem=spec.make_mem,
                registry_name=source,
            )
        if isinstance(source, DFG):
            return Program(name=source.name, origin="dfg", dfg=source)
        if hasattr(source, "spec") and hasattr(source, "build"):
            # TracedKernel: legalize to a fresh LoopBuilder
            builder = source.build()
            return Program(
                name=source.name,
                origin="traced",
                dfg=builder.build_dfg(),
                builder=builder,
                make_mem=getattr(source, "make_mem", None),
            )
        if hasattr(source, "build_dfg"):
            # a LoopBuilder handed in directly
            return Program(
                name=getattr(source, "name", "<inline>"),
                origin="inline",
                dfg=source.build_dfg(),
                builder=source,
            )
        msg = (
            f"unsupported kernel source {type(source).__name__}: expected "
            "a registry name, LoopBuilder, TracedKernel, DFG or Program"
        )
        raise StageError("source", msg)

    # -- stage 2: Program -> MapResult -------------------------------------

    def map(
        self,
        source,
        ii_start: Optional[int] = None,
        config: Optional[MapperConfig] = None,
        jobs: Optional[int] = None,
    ) -> MapResult:
        """SAT-map with the session's CEGAR oracle wired in.  ``jobs``
        bounds the JAX package's portfolio racer, not ported yet: anything
        but ``None`` raises."""
        _refuse_jobs(jobs)
        return self._map(self.program(source), ii_start=ii_start,
                         config=config)

    def _oracle_check(self, prog: Program):
        if self._oracle_factory is None or prog.builder is None:
            return None
        if (self._oracle_factory is assembler_oracle
                and not self.grid.assemblable):
            # diagonal / one-hop interconnects cannot be assembled, so the
            # codegen oracle has nothing to say (map-only architectures)
            return None
        return self._oracle_factory(prog.builder)

    def _map(
        self,
        prog: Program,
        ii_start: Optional[int] = None,
        config: Optional[MapperConfig] = None,
    ) -> MapResult:
        return map_dfg(prog.dfg, self.grid, config or self.config,
                       ii_start=ii_start,
                       assemble_check=self._oracle_check(prog))

    # -- stage 3: Mapping -> AssembledCIL ----------------------------------

    def assemble(self, source, mapping: Mapping) -> AssembledCIL:
        prog = self.program(source)
        if prog.builder is None:
            msg = (
                f"{prog.name!r} is a bare DFG (origin={prog.origin!r}): "
                "code generation needs a LoopBuilder program"
            )
            raise StageError("assemble", msg)
        try:
            return assemble(prog.builder, mapping)
        except Exception as e:
            raise StageError("assemble", format_error(e), cause=e) from e

    # -- stage 4: AssembledCIL -> RuntimeMetrics ---------------------------

    def metrics(
        self,
        source,
        mapping: Mapping,
        asm: Optional[AssembledCIL] = None,
    ) -> RuntimeMetrics:
        """Calibrated latency/energy model over the assembled grid (no
        execution).  Re-assembles unless the stage-3 artifact is passed
        in.  Capability-annotated architectures get the capability-aware
        static model; plain grids keep the homogeneous constant."""
        if asm is None:
            asm = self.assemble(source, mapping)
        arch_grid = (self.grid if self.grid.caps is not None
                     or self.grid.spec.num_regs != 4 else None)
        try:
            return runtime_metrics(
                asm,
                num_cols=self.grid.spec.cols,
                utilization=mapping.utilization,
                grid=arch_grid,
            )
        except Exception as e:
            raise StageError("metrics", format_error(e), cause=e) from e

    # -- stage 5 (optional): execute on the PE-array simulator -------------

    def simulate(
        self,
        source,
        mapping: Mapping,
        mem,
        batch: int = 1,
        device="cuda",
    ):
        """Run the mapped bitstream on the PE array (the CUDA kernel on the
        card unless ``device="cpu"``); returns a
        :class:`~repro_torch.cgra.simulator.SimResult`."""
        prog = self.program(source)
        if prog.builder is None:
            msg = (
                f"{prog.name!r} is a bare DFG: execution needs a "
                "LoopBuilder program"
            )
            raise StageError("simulate", msg)
        try:
            from ..cgra.simulator import simulate

            return simulate(prog.builder, mapping, mem, batch=batch,
                            device=device)
        except StageError:
            raise
        except Exception as e:
            raise StageError("simulate", format_error(e), cause=e) from e

    # -- end-to-end --------------------------------------------------------

    def compile(
        self,
        source,
        ii_start: Optional[int] = None,
        config: Optional[MapperConfig] = None,
        jobs: Optional[int] = None,
    ) -> CompileResult:
        """source -> map -> assemble -> metrics, never raising: failures
        come back as a :class:`CompileResult` with ``stage`` set.

        ``CompileResult.timings`` is a projection of the stage trace
        spans (:mod:`repro_torch.obs.trace`): each stage runs inside a
        ``stage.*`` span whose duration is what lands in ``timings`` —
        with tracing disabled the spans degrade to plain timers, so the
        dict is populated either way and result bytes never change."""
        _refuse_jobs(jobs)
        rows, cols = self.grid.spec.rows, self.grid.spec.cols
        if isinstance(source, str):
            kernel = source
        else:
            kernel = getattr(source, "name", type(source).__name__)
        with obs_trace.span("compile", kernel=kernel,
                            grid=f"{rows}x{cols}", arch=self.arch) as csp:
            cr = self._compile_staged(source, kernel, ii_start, config)
            csp.set(status=cr.status, stage=cr.stage,
                    cache_hit=cr.cache_hit, ii=cr.ii)
        return cr

    def _compile_staged(
        self,
        source,
        kernel: str,
        ii_start: Optional[int],
        config: Optional[MapperConfig],
    ) -> CompileResult:
        rows, cols = self.grid.spec.rows, self.grid.spec.cols
        timings: Dict[str, float] = {}
        ssp = obs_trace.timed_span("stage.source", kernel=kernel)
        try:
            with ssp:
                prog = self.program(source)
        except StageError as e:
            return CompileResult(
                kernel=kernel,
                rows=rows,
                cols=cols,
                status="error",
                arch=self.arch,
                stage=e.stage,
                error=e.error_text(),
                timings={"source": ssp.dur},
            )
        timings["source"] = ssp.dur
        cr = CompileResult(
            kernel=prog.name,
            rows=rows,
            cols=cols,
            status="error",
            arch=self.arch,
            program=prog,
            timings=timings,
        )

        msp = obs_trace.timed_span("stage.map", kernel=prog.name)
        try:
            with msp:
                res = self._map(prog, ii_start=ii_start, config=config)
                msp.set(cache_hit=False, status=res.status)
        except Exception as e:
            timings["map"] = msp.dur
            cr.stage, cr.error = "map", format_error(e)
            return cr
        timings["map"] = msp.dur
        cr.map_result = res
        if res.mapping is None:
            cr.status, cr.stage = res.status, "map"
            return cr

        return self._finish(cr)

    def _finish(self, cr: CompileResult) -> CompileResult:
        """Run the post-map stages on an already-mapped result."""
        prog, mapping = cr.program, cr.mapping
        asp = obs_trace.timed_span("stage.assemble", kernel=cr.kernel)
        try:
            with asp:
                cr.asm = self.assemble(prog, mapping)
        except StageError as e:
            cr.timings["assemble"] = asp.dur
            cr.status, cr.stage = "error", e.stage
            cr.error = e.error_text()
            return cr
        cr.timings["assemble"] = asp.dur
        msp = obs_trace.timed_span("stage.metrics", kernel=cr.kernel)
        try:
            with msp:
                cr.metrics = self.metrics(prog, mapping, cr.asm)
        except StageError as e:
            cr.timings["metrics"] = msp.dur
            cr.status, cr.stage = "error", e.stage
            cr.error = e.error_text()
            return cr
        cr.timings["metrics"] = msp.dur
        cr.status, cr.stage, cr.error = "ok", None, None
        return cr

    # -- fan-out -----------------------------------------------------------

    def compile_many(self, *args, **kwargs):
        """The JAX package's supervised fleet over a kernels x grids cross
        product; not ported yet (``ROADMAP.md``)."""
        raise NotImplementedError(
            "Toolchain.compile_many (the resilient compile fleet) is not "
            "ported yet (ROADMAP.md); call compile() per point")


def _refuse_jobs(jobs: Optional[int]) -> None:
    if jobs is not None:
        raise NotImplementedError(
            "jobs= sizes the portfolio racer, which is not ported yet "
            "(ROADMAP.md)")
