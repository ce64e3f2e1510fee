"""Observability: profiling scopes, structured dispatch logging.

The reference has no tracing/metrics at all (SURVEY.md §5); these are the
JAX-native equivalents: `jax.named_scope`/`jax.profiler` wrappers so the
three kernel stages show up in XProf/Perfetto, and structured logging of
every backend-dispatch decision (dtype, path, sharding) — the analogue of
being able to see which of the reference's six template instantiations the
ctor picked (reference src/SangNom2.cpp:312-329).
"""

from sangnom_jax.utils.profiling import profile_trace, stage_scope  # noqa: F401
from sangnom_jax.utils.logging import get_logger, log_dispatch  # noqa: F401
