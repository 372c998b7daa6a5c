"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain versions.

``build.py`` compiles ``csrc/*.cu`` with nvcc at first launch; importing this
package builds nothing."""
