"""Run-time support of the port: building the CUDA kernels, the corpus
pipeline, the folder benchmark and the profiler."""
