"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers and plain
PyTorch versions.  Nothing is built or loaded at import: a kernel is compiled
with ``nvcc`` the first time a CUDA tensor reaches it (``_build.py``)."""
