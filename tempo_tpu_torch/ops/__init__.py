"""Device ops: hashing, merge, bloom, sketches (torch) and the CUDA kernels."""
