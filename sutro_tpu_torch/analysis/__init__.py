"""graftlint: engine-aware static analysis for sutro_tpu_torch.

AST-walking passes that enforce the concurrency and accelerator
discipline the engine's dynamic tests only catch probabilistically:
lock-order consistency, no blocking I/O or callbacks under locks, device
entry-point purity / scheduler determinism, thread teardown hygiene, and no silent
exception swallows. See ``core.RULES`` for the catalog, ``__main__``
for the CLI, and ``baseline.json`` for the accepted pre-existing
findings the CI gate diffs against.

Programmatic use::

    from sutro_tpu_torch.analysis import analyze
    findings, suppressed, index = analyze(["sutro_tpu_torch"])
"""

from .core import (  # noqa: F401
    Finding,
    RULES,
    analyze,
    baseline_counts,
    compare_baseline,
    load_baseline,
    write_baseline,
)
