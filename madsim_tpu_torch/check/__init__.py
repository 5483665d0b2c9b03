"""Operation-history checkers for the torch port's recorded histories.

The batched engine appends fixed-size per-seed history columns
(``Workload.history = HistorySpec(...)`` and ``EmitBuilder.record``,
``engine/core.py``); this package judges them on the host, as the JAX
package's ``madsim_tpu.check`` does:

* ``history.py``: :class:`BatchHistory` over the whole seed batch, and
  the pairing of one seed's records into :class:`Op` operations;
* ``vectorized.py``: the cheap batch detectors (stale reads,
  read-your-writes, monotonic reads, election, lease and shard safety,
  exactly-once, recovery safety), each an ``(S,)`` verdict, the
  ``search_seeds(history_invariant=...)`` contract;
* ``linearize.py``: the exact Wing–Gong checker for register and KV
  histories, per seed.

The three modules are copies of the JAX package's, which the port does
not import. Its device screens (``check/device.py``), SLO checks
(``check/slo.py``) and asyncio ``Recorder`` are not ported yet
(ROADMAP.md).
"""

from .history import (  # noqa: F401
    COL_ARG,
    COL_CLIENT,
    COL_KEY,
    COL_OK,
    COL_OP,
    OK_FAIL,
    OK_OK,
    OK_PENDING,
    OP_READ,
    OP_USER,
    OP_WRITE,
    BatchHistory,
    HistoryError,
    Op,
)
from .linearize import LinResult, check_kv, check_register  # noqa: F401
from .vectorized import (  # noqa: F401
    collapse_retries,
    election_safety,
    exactly_once,
    lease_safety,
    monotonic_reads,
    monotonic_reads_strict,
    read_your_writes,
    recovery_safety,
    shard_coverage,
    stale_reads,
)

__all__ = [
    "COL_ARG",
    "COL_CLIENT",
    "COL_KEY",
    "COL_OK",
    "COL_OP",
    "OK_FAIL",
    "OK_OK",
    "OK_PENDING",
    "OP_READ",
    "OP_USER",
    "OP_WRITE",
    "BatchHistory",
    "HistoryError",
    "LinResult",
    "Op",
    "check_kv",
    "check_register",
    "collapse_retries",
    "election_safety",
    "exactly_once",
    "lease_safety",
    "monotonic_reads",
    "monotonic_reads_strict",
    "read_your_writes",
    "recovery_safety",
    "shard_coverage",
    "stale_reads",
]
