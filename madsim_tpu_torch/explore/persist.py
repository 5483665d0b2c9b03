"""Campaign corpus save / resume.

Port of ``madsim_tpu/explore/persist.py``: the JSON document is the
JAX package's key for key, so a checkpoint written by either package
resumes in the other.

A coverage-guided hunt is an investment: the corpus and the global
coverage map ARE the knowledge a campaign has accumulated, and before
this module they died with the process (``LiteralPlan.to_dict``
serialized single entries, but nothing carried a whole campaign). A
:class:`CampaignState` checkpoints exactly the loop state the driver
threads between generations — corpus entries (each an exact-replay
``(seed, LiteralPlan)`` pair), violations, the coverage map, the
dedup set and the id/generation counters — as one JSON document, so

    rep = explore.run(wl, cfg, space, generations=4, batch=256,
                      checkpoint_path="hunt.json")
    # ... later, a different session ...
    rep2 = explore.run(wl, cfg, space, generations=4, batch=256,
                       resume="hunt.json")

continues the SAME campaign: because every draw is keyed by the
absolute generation index (driver ``_derive_keys``), a resumed run is
bit-identical to the uninterrupted one — corpus, coverage map and
violation set all match (the test pins it). Python ints serialize
losslessly in JSON, so uint64 seeds and trace hashes round-trip exact.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..chaos.plan import LiteralPlan
from .driver import CorpusEntry

__all__ = ["CampaignState", "resolve_resume", "save_campaign",
           "load_campaign"]

_FORMAT = 1


def _entry_to_dict(e: CorpusEntry) -> dict:
    return {
        "id": e.id,
        "generation": e.generation,
        "parent": e.parent,
        "seed": int(e.seed),
        "plan": e.plan.to_dict(),
        "trace": int(e.trace),
        "cov": [int(w) for w in np.asarray(e.cov, np.uint32)],
        "new_bits": e.new_bits,
        "violating": e.violating,
        "halt_t": int(e.halt_t),
    }


def _entry_from_dict(d: dict) -> CorpusEntry:
    return CorpusEntry(
        id=int(d["id"]),
        generation=int(d["generation"]),
        parent=int(d["parent"]),
        seed=int(d["seed"]),
        plan=LiteralPlan.from_dict(d["plan"]),
        trace=int(d["trace"]),
        cov=np.asarray(d["cov"], np.uint32),
        new_bits=int(d["new_bits"]),
        violating=bool(d["violating"]),
        halt_t=int(d.get("halt_t", 0)),
    )


@dataclasses.dataclass
class CampaignState:
    """Everything ``explore.run`` threads between generations.

    ``corpus`` and ``violations`` may share entries (a violating entry
    is usually admitted too); serialization stores each entry once and
    reconstitutes the sharing by id.
    """

    workload: str
    config_hash: str
    plan_hash: str
    root_seed: int
    batch: int
    cov_words: int
    cov_hitcount: bool
    generations_done: int
    next_id: int
    sims: int
    curve: list
    viol_curve: list
    cov_map: np.ndarray  # (CW,) uint32
    corpus: list  # list[CorpusEntry], admission order
    violations: list  # list[CorpusEntry] (includes corpus-capped finds)

    @classmethod
    def from_report(cls, report) -> "CampaignState":
        """Snapshot a finished campaign from its ExploreReport."""
        return cls(
            workload=report.workload,
            config_hash=report.config_hash,
            plan_hash=report.plan_hash,
            root_seed=report.root_seed,
            batch=report.batch,
            cov_words=report.cov_words,
            cov_hitcount=getattr(report, "cov_hitcount", False),
            generations_done=report.generations,
            next_id=report.next_id,
            sims=report.sims,
            curve=list(report.curve),
            viol_curve=list(report.viol_curve),
            cov_map=np.asarray(report.cov_map, np.uint32),
            corpus=list(report.corpus),
            violations=list(report.violations),
        )

    def to_dict(self) -> dict:
        entries: dict[int, CorpusEntry] = {}
        for e in list(self.corpus) + list(self.violations):
            entries[e.id] = e
        return {
            "format": _FORMAT,
            "workload": self.workload,
            "config_hash": self.config_hash,
            "plan_hash": self.plan_hash,
            "root_seed": int(self.root_seed),
            "batch": self.batch,
            "cov_words": self.cov_words,
            "cov_hitcount": self.cov_hitcount,
            "generations_done": self.generations_done,
            "next_id": self.next_id,
            "sims": self.sims,
            "curve": list(self.curve),
            "viol_curve": list(self.viol_curve),
            "cov_map": [int(w) for w in np.asarray(self.cov_map, np.uint32)],
            "entries": [
                _entry_to_dict(entries[i]) for i in sorted(entries)
            ],
            "corpus_ids": [e.id for e in self.corpus],
            "violation_ids": [e.id for e in self.violations],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignState":
        if d.get("format") != _FORMAT:
            raise ValueError(
                f"unknown campaign checkpoint format {d.get('format')}"
            )
        entries = {
            int(ed["id"]): _entry_from_dict(ed) for ed in d["entries"]
        }
        return cls(
            workload=d["workload"],
            config_hash=d["config_hash"],
            plan_hash=d["plan_hash"],
            root_seed=int(d["root_seed"]),
            batch=int(d["batch"]),
            cov_words=int(d["cov_words"]),
            cov_hitcount=bool(d.get("cov_hitcount", False)),
            generations_done=int(d["generations_done"]),
            next_id=int(d["next_id"]),
            sims=int(d["sims"]),
            curve=list(d["curve"]),
            viol_curve=list(d["viol_curve"]),
            cov_map=np.asarray(d["cov_map"], np.uint32),
            corpus=[entries[int(i)] for i in d["corpus_ids"]],
            violations=[entries[int(i)] for i in d["violation_ids"]],
        )

    def save(self, path: str) -> None:
        # write-then-rename: the checkpoint is overwritten after every
        # generation, and a kill mid-dump must not destroy the only
        # copy of the campaign it exists to preserve
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CampaignState":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def resolve_resume(resume, wl, space, cfg, root_seed: int, batch: int,
                   cov_words: int, cov_hitcount: bool) -> CampaignState:
    """Load (path or state) and validate a campaign checkpoint against
    this run's arguments — shared by BOTH campaign drivers
    (explore.run and explore.run_device), so a field added to the
    identity tuple cannot be validated on one path and silently
    accepted on the other."""
    st = CampaignState.load(resume) if isinstance(resume, str) else resume
    for what, got, want in (
        ("workload", st.workload, wl.name),
        ("plan-space hash", st.plan_hash, space.hash()),
        ("config hash", st.config_hash, cfg.hash()),
        ("root seed", st.root_seed, int(root_seed)),
        ("batch", st.batch, batch),
        ("cov_words", st.cov_words, cov_words),
        ("cov_hitcount", st.cov_hitcount, cov_hitcount),
    ):
        if got != want:
            raise ValueError(
                f"campaign checkpoint {what} mismatch: saved {got!r}, "
                f"this run has {want!r} — resuming would break the "
                f"pure-function-of-root-seed contract"
            )
    return st


def save_campaign(path: str, report) -> CampaignState:
    """Checkpoint a finished campaign's ExploreReport to ``path``."""
    st = CampaignState.from_report(report)
    st.save(path)
    return st


def load_campaign(path: str) -> CampaignState:
    return CampaignState.load(path)
