"""CUDA C++ sources of the port's kernels (built by `ops/kernels.py`)."""
