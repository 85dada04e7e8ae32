"""The PE-array cycle step and whole-program run (CUDA kernels and plain
versions) and run_program."""
