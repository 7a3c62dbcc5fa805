"""Static analysis + runtime sanitizers of the port (the counterpart of
`repro.analysis`, in PyTorch idiom; imports neither ``jax`` nor ``repro``).

The serving claims the port makes — a fused route that copies to the host
once, a lock-guarded streaming index, an artifact schema shared with the
reference, CUDA graphs captured once — are invariants, not behaviours a
unit test can pin once and forget.  This package machine-checks them:

  * `lint` + `rules/` — an AST lint engine with the reference's six rules
    restated for the port: R1 no host sync (``.cpu()``, ``.item()``,
    ``.tolist()``, ``.numpy()``, ``synchronize``, ``np.asarray``, ...)
    reachable from the fused serving roots, R2 lock discipline on
    `DynamicIVFIndex` state, R3 artifact-schema drift requires a
    ``FORMAT_VERSION`` bump, R4 CUDA-graph / ``torch.compile`` cache
    hygiene, R5 no bare/silent ``except`` in the serving tree, R6 artifact
    and WAL writes go through `repro_torch.persist`'s atomic helpers.
  * `sanitizers` — runtime counterparts: a sync counter over
    ``torch.cuda.set_sync_debug_mode``, a cache-growth counter, and a
    deadlock watchdog.

``python -m repro_torch.analysis.lint`` runs the engine over
``src/repro_torch`` and fails on any non-baselined finding.  The shipped
baseline is empty.
"""
from .core import Finding, load_baseline, write_baseline


def __getattr__(name):
    # the engine loads on first use, so ``python -m
    # repro_torch.analysis.lint`` runs a module not yet imported
    if name in ("lint_paths", "lint_tree"):
        from . import lint
        return getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Finding", "load_baseline", "write_baseline", "lint_paths",
           "lint_tree"]
