"""Hand-written CUDA kernels (sources beside this file) and their build."""
