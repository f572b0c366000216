"""Helpers for the PyTorch port's tests that compile JAX references."""

import jax


def jit_o0(fn):
    """jax.jit for a one-shot reference, compiled without XLA's backend
    optimisations: they cost more compile time than they save on one call."""
    def run(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})(*args)
    return run
