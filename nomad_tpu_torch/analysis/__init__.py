"""Static concurrency/telemetry lint + runtime lock diagnostics.

The static side (``framework``/``checkers``) is an AST pass over the
package tree hosting the lock-discipline, retry-discipline, thread-
lifecycle, exception-swallow, and telemetry-key checkers behind the
``nomad-tpu lint`` CLI and the tier-1 ``tests/test_torch_lint.py``
gate (the Python analogue of the `go vet` pass the reference leans on).

The runtime side (``debug_locks``) is an opt-in lock-order detector in
the Eraser/ThreadSanitizer lineage: ``NOMAD_TPU_DEBUG_LOCKS=1`` swaps
``threading.Lock``/``RLock`` for wrappers that maintain a process-wide
lock-order graph and report order inversions, over-long holds, and
blocking primitives invoked under a lock.

Copied from nomad_tpu/analysis/__init__.py; only the name of the gate's
test file differs. The checkers scan this package's own tree.
"""

from .annotations import guarded_by, requires_lock
from .findings import Finding
from .framework import all_checkers, run_checks

__all__ = ["Finding", "all_checkers", "guarded_by", "requires_lock",
           "run_checks"]
