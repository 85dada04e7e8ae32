"""The PE-array cycle step (CUDA kernel and plain version) and run_program."""
