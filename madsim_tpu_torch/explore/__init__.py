"""Coverage-guided schedule exploration (port of ``madsim_tpu.explore``).

MadSim finds rare interleavings by brute chaos: sweep enough random
seeds and hope. The exploration subsystem upgrades the batched engine
from that blind sweep into an AFL-style greybox fuzzer over
distributed-protocol state space:

* **on-device coverage** (``make_init(cov_words=...)``) — every seed
  folds behavior features (per-node event-kind transitions, chaos kind
  x time-phase markers, history-record words) into a per-seed bitmap;
  only bitmaps and popcount deltas cross to the host, never raw traces;
* **a corpus** of interesting ``(seed, LiteralPlan)`` entries — kept
  iff they set new bits in the global coverage map (or violate);
* **a mutation engine** (explore/mutate.py) — retime / retarget /
  drop / add over the plan's slots, every draw threefry-keyed from the
  campaign's root seed;
* **the driver** (explore/driver.py) — each generation is ONE batch
  through ``search_seeds`` (the run kernel on the card); violations
  carry a complete ``(root seed, generation, entry id)`` repro key and
  feed ``chaos.shrink_plan`` directly;
* **the device campaign** (explore/device.py, ``run_device``) — the
  same loop with the corpus, the mutator and the admission on the
  card, one host sync a generation, bit-identical to the host driver;
* **persistence** (explore/persist.py) — campaign checkpoints in the
  JAX package's JSON, resumable by either driver and either package.
"""

from .coverage import admit, merge, popcount  # noqa: F401
from .device import run_device  # noqa: F401
from .driver import (  # noqa: F401
    CorpusEntry,
    ExploreReport,
    replay_entry,
    run,
)
from .mutate import (  # noqa: F401
    HostStream,
    PlanSpace,
    mutate_plan,
    mutation_table,
)
from .persist import (  # noqa: F401
    CampaignState,
    load_campaign,
    save_campaign,
)

__all__ = [
    "CampaignState",
    "CorpusEntry",
    "ExploreReport",
    "HostStream",
    "PlanSpace",
    "admit",
    "load_campaign",
    "merge",
    "mutate_plan",
    "mutation_table",
    "popcount",
    "replay_entry",
    "run",
    "run_device",
    "save_campaign",
]
