"""Trace kernels and their adjoints: CUDA C++ for sm_90a (../csrc), each
with its plain PyTorch version in the same module (chain_trace.py,
spp_trace.py, chain_grad.py, wavefront_trace.py, wavefront_grad.py).
Importing them builds nothing; the CUDA library is compiled and loaded at
the first launch (_build.py). The wrappers are not re-exported here, so
that `kernels.chain_trace` and the others stay the modules."""
