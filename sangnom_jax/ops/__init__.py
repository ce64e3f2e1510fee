"""Compute ops: the SangNom kernel (jnp reference + fused Pallas) and the
frame-level orchestration."""

from sangnom_jax.ops.sangnom import sangnom2_op  # noqa: F401
