"""Compile accounting: programs compiled as a first-class metric.

Counterpart of `keystone_tpu/telemetry/compile_events.py:1-129`,
re-derived for the card. There is no XLA compile to observe here; what
compiles is:

  - a library built from ``csrc/`` by `ops/_build.py` (``nvcc`` for the
    kernels and the nvJPEG decoder, ``c++`` for the host libraries): a
    cold compile;
  - a library built earlier and only loaded: a cache hit (its load
    seconds are the warm retrieval);
  - a CUDA graph capture (`utils/graphs.py::CapturedLoop`, through
    `FusedBatchTransformer.run_rung`): a cold compile of the chain's
    padded loop, whose replays are then dispatches.

The metrics keep JAX's names and shape:

  dispatch.programs_compiled   (counter) cold compiles
  dispatch.compile_cache_hits  (counter) loads of a library built earlier
  compile.cold_secs            (histogram) seconds of each cold compile
  compile.warm_secs            (histogram) seconds of each load

With a tracer active each one also records a closed ``cat="compile"``
span whose ``kind`` says what compiled (``kernel``, ``host`` or
``graph``) and whose ``name`` says which library or chain.
"""

from __future__ import annotations

from .metrics import counter, histogram
from .spans import current_tracer

# registered at import, so a trace of a fully warm run reports "0 cold"
# instead of lacking the counters
_COMPILED = counter("dispatch.programs_compiled")
_HITS = counter("dispatch.compile_cache_hits")
_COLD = histogram("compile.cold_secs")
_WARM = histogram("compile.warm_secs")


def record_compile(name: str, seconds: float, cold: bool,
                   kind: str) -> None:
    """Count one compile (``cold``) or cache hit of ``name`` that took
    ``seconds``; ``kind`` is ``kernel``, ``host`` or ``graph``."""
    if cold:
        _COMPILED.inc()
        _COLD.observe(seconds)
    else:
        _HITS.inc()
        _WARM.observe(seconds)
    tracer = current_tracer()
    if tracer is not None:
        tracer.record_complete(
            "compile", "compile", max(0.0, tracer.now() - seconds), seconds,
            cold=cold, kind=kind, target=name, seconds=round(seconds, 6))


def compiles_snapshot() -> dict:
    """Point-in-time compile accounting: cold compiles, cache hits and
    their seconds (JAX's shape)."""
    cold = _COLD.snapshot()
    warm = _WARM.snapshot()
    return {
        "programs_compiled": int(_COMPILED.value),
        "compile_cache_hits": int(_HITS.value),
        "cold_compile_secs": round(cold["total"], 4),
        "warm_retrieval_secs": round(warm["total"], 4),
    }
