"""madsim_tpu_torch.lint — determinism analysis of the port.

Port of ``madsim_tpu/lint``. Every seed's run must be exact and
replayable, and every observability column write-only with respect to
the trajectory. Three checks hold that on the port:

* :func:`lint_paths` / :func:`lint_repo` — the JAX package's AST linter,
  its rules unchanged, over ``madsim_tpu_torch/``: wall clocks, ambient
  entropy, ``uuid``, un-threefry'd ``np.random``, unordered-set
  iteration, ``id()``/``hash()`` in branch conditions, host callbacks
  and fixed keys in sim code, with the checked ``# lint: allow(rule)``
  allowlist (a pragma that suppresses nothing is an ``unused-allow``
  finding).
* :func:`check_noninterference` — the derived columns
  (``engine.derived_fields``) perturbed within their contracts before
  every chunk of a run, through the plain step, the run kernel or its
  host build, with the core columns and the trace required to stay
  equal (the JAX package proves the same statically on jaxprs, which
  the port does not have).
* the JAX package's other axes as dynamic checks with live controls:
  :data:`CHECK_AXES` (``check_noninterference(verdict=...)``: a device
  verdict reads the history columns and nothing else derived),
  :data:`CAMPAIGN_AXES` and :data:`FLIGHT_AXES` (:func:`check_campaign`:
  a campaign's children through its runner, unsharded and sharded, and
  its outcome under perturbed final views, with and without the flight
  recorder).
* :func:`check_lanes` and :func:`check_ranges` — every draw site of the
  port resolved to its registered threefry lane with the right owner,
  and a state held to its column contracts at chunk boundaries.

``python -m madsim_tpu_torch.lint [--noninterference] [--lanes]`` runs
them and fails on any finding.
"""

from .absint import (  # noqa: F401
    LaneSite,
    RangeCheck,
    check_kernel_constants,
    check_lane_site,
    check_lanes,
    check_model_purposes,
    check_ranges,
    scan_draw_sites,
)
from .noninterference import (  # noqa: F401
    BUILD_AXES,
    CAMPAIGN_AXES,
    CHECK_AXES,
    FLIGHT_AXES,
    NonInterferenceReport,
    check_campaign,
    check_matrix,
    check_noninterference,
    model_matrix,
    perturb_derived,
    plant_met_leak,
    screens_verdict,
)
from .rules import (  # noqa: F401
    DEFAULT_PATHS,
    RULES,
    Finding,
    LintResult,
    is_sim_code,
    lint_paths,
    lint_repo,
    lint_source,
)

__all__ = [
    "LaneSite",
    "RangeCheck",
    "check_kernel_constants",
    "check_lane_site",
    "check_lanes",
    "check_model_purposes",
    "check_ranges",
    "scan_draw_sites",
    "BUILD_AXES",
    "CAMPAIGN_AXES",
    "CHECK_AXES",
    "FLIGHT_AXES",
    "NonInterferenceReport",
    "check_campaign",
    "check_matrix",
    "check_noninterference",
    "model_matrix",
    "perturb_derived",
    "plant_met_leak",
    "screens_verdict",
    "DEFAULT_PATHS",
    "RULES",
    "Finding",
    "LintResult",
    "is_sim_code",
    "lint_paths",
    "lint_repo",
    "lint_source",
]
