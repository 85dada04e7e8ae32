"""repro_torch: the PyTorch/CUDA port of the SAT-MapIt reproduction.

Loop kernels are mapped onto a CGRA by an exact SAT-based modulo scheduler
on the host, assembled into bitstreams, and run on a cycle-accurate
PE-array simulator that runs a whole program in one hand-written CUDA
kernel launch on the card (``kernels/csrc/pe_array.cu``) and in plain
PyTorch on the CPU:

* :mod:`repro_torch.sat`       CNF/Tseitin and the CDCL solver
* :mod:`repro_torch.core`      DFG, KMS, SAT encoding, solver sessions,
  the II ladder with CEGAR, the portfolio racer, the cross-point fact
  store, register allocation
* :mod:`repro_torch.archspec`  declarative architectures and presets
* :mod:`repro_torch.cgra`      ISA, grid, CIL programs and the kernel
  registry, the assembler, artifacts, simulate/verify, the latency/energy
  model
* :mod:`repro_torch.toolchain` the compilation session, ``compile_many``
  over the supervised worker fleet (retries, degradation, chaos), the
  wire views of its results; ``python -m repro_torch map``
* :mod:`repro_torch.serve`     the asyncio compile server, its wire
  protocol (the JAX package's, byte for byte) and clients;
  ``python -m repro_torch serve`` / ``submit``
* :mod:`repro_torch.dse`       the content-addressed mapping cache
* :mod:`repro_torch.kernels`   the cycle step and the whole-program run
  (kernels + plain versions) and ``run_program``
* :mod:`repro_torch.fuzz`      seeded corpora, the batched oracle, the
  differential fuzz engine (one kernel, or K kernels stacked in one
  launch), triage and the switching-activity harvest;
  ``python -m repro_torch fuzz``
* :mod:`repro_torch.obs`       trace spans of the mapper and toolchain
* :mod:`repro_torch.convert`   hands the JAX package's state across

Entry points that execute run on the card unless called with
``device="cpu"``.  The package imports neither ``jax`` nor ``repro``.
"""
