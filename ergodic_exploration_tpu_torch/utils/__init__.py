"""Numerics, JAX-exact random bits, shared-geometry guards, state interop
and the CUDA build helper."""
