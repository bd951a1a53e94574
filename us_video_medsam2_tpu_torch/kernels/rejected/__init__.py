"""Counterparts of the JAX package's ``kernels/rejected/``: kernels that the
JAX package keeps unwired after a TPU A/B, ported as they are (a kernel, its
plain version, its gradient) and wired into no model."""
