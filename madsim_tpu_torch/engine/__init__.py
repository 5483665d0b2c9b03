"""The batched simulation engine on torch (port of madsim_tpu.engine)."""

from .core import (  # noqa: F401
    FIRST_EXT_KIND,
    FIRST_USER_KIND,
    KIND_CLOG,
    KIND_CLOG_1W,
    KIND_CLOG_NODE,
    KIND_DUP_OFF,
    KIND_DUP_ON,
    KIND_HALT,
    KIND_KILL,
    KIND_NOP,
    KIND_PAUSE,
    KIND_RESTART,
    KIND_RESUME,
    KIND_SKEW,
    KIND_SLOW_LINK,
    KIND_SYNC_LOSS,
    KIND_SYNC_OK,
    KIND_TORN_OFF,
    KIND_TORN_ON,
    KIND_UNCLOG,
    KIND_UNCLOG_1W,
    KIND_UNCLOG_NODE,
    KIND_UNSLOW,
    COVERAGE_FIELDS,
    METRIC_NAMES,
    N_METRICS,
    OBS_FIELDS,
    SLOW_MULT_MAX,
    STATE_FIELDS,
    STORAGE_FIELDS,
    TIMELINE_FIELDS,
    EmitBuilder,
    Emits,
    EngineConfig,
    HandlerCtx,
    HistorySpec,
    PlanRows,
    SimState,
    Workload,
    make_init,
    make_run,
    make_run_plain,
    make_run_while,
    make_run_while_plain,
    make_step,
    make_step_plain,
    pack_slow_arg,
    resolve_device,
    set_cols,
    unpack_slow_arg,
    user_kind,
)
from .convert import state_from_numpy, state_to_numpy  # noqa: F401
from .fused import make_run_fused  # noqa: F401
from .rng import Draw, threefry2x32  # noqa: F401
from .compact import make_run_compacted, make_run_compacted_plain  # noqa: F401
from .verify import (  # noqa: F401
    DERIVED_FIELDS,
    HISTORY_FIELDS,
    DeterminismError,
    check_determinism,
    check_layouts,
    compare_fields,
    compare_traces,
)
from .checkpoint import load as load_checkpoint  # noqa: F401
from .checkpoint import save as save_checkpoint  # noqa: F401
from .search import SearchReport, make_sweep, search_seeds  # noqa: F401
from .replay import ReplayEvent, format_timeline, refold, replay  # noqa: F401
