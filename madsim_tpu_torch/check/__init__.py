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
  histories, per seed;
* ``device.py``: the same detectors as batched torch ops on the
  columns' own device (:class:`HistoryScreen`), with packed verdict
  words and the prefix-compaction fold, for
  ``search_seeds(device_check=...)`` and
  ``make_run_compacted(hist_screen=...)``.

The first three modules are copies of the JAX package's, which the port
does not import; ``device.py`` ports its jnp screens to torch. The SLO
checks (``slo.py``: ``slo_breaches`` and ``slo_bounded``) judge the
latency sketches on numpy, ``device.slo_breaches`` as torch ops.

``recorder.py`` (:class:`Recorder`) records an application on the
single-seed runtime (real coroutines, RPC, fs) in the same (op, key,
arg, client, ok, t) rows, stamped with the runtime's virtual clock, so
that the same checkers judge both execution modes.
"""

from . import device  # noqa: F401
from .slo import slo_bounded, slo_breaches  # noqa: F401
from .device import HistoryScreen  # noqa: F401
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
from .recorder import Recorder  # noqa: F401
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
    "HistoryScreen",
    "LinResult",
    "Op",
    "Recorder",
    "check_kv",
    "check_register",
    "device",
    "collapse_retries",
    "election_safety",
    "exactly_once",
    "lease_safety",
    "monotonic_reads",
    "monotonic_reads_strict",
    "read_your_writes",
    "recovery_safety",
    "shard_coverage",
    "slo_bounded",
    "slo_breaches",
    "stale_reads",
]
