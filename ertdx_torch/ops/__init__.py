"""Hand-written CUDA kernels of the port, each beside its plain version."""
