"""Run-time support of the port: building the CUDA kernels."""
