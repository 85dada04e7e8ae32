"""repro_torch: the PyTorch/CUDA port of the CGRA execution side.

Mapped-kernel artifacts (``repro_torch/artifacts``) run on a cycle-accurate
PE-array simulator that runs a whole program in one hand-written CUDA
kernel launch on the card (``kernels/csrc/pe_array.cu``) and in plain
PyTorch on the CPU:

* :mod:`repro_torch.cgra`    ISA, grid, program, artifacts, simulate/verify,
  the latency/energy model
* :mod:`repro_torch.kernels` the cycle step and the whole-program run
  (kernels + plain versions) and ``run_program``
* :mod:`repro_torch.fuzz`    seeded corpora, the batched oracle, the
  differential fuzz engine (one kernel, or K kernels stacked in one
  launch), triage and the switching-activity harvest;
  ``python -m repro_torch fuzz``
* :mod:`repro_torch.convert` hands the JAX package's state across as numpy

Entry points run on the card unless called with ``device="cpu"``.  The
package imports neither ``jax`` nor ``repro``.
"""
