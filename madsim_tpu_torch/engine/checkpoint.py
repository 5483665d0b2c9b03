"""Checkpoint and resume of batched simulation state.

Port of ``madsim_tpu/engine/checkpoint.py``, in its file format 11: one
``.npz`` with an entry per ``SimState`` field, in the JAX package's
dtypes, and a manifest entry recording the format, the config hash
(resuming under another config would silently change the trajectory)
and the event-time dtype. A checkpoint plus its (workload, config)
resumes to the same trajectory as the uninterrupted run.

The files cross both ways. :func:`save` writes the port's fields and,
for each field of the JAX package's ``SimState`` that the port does
not carry (``convert.FOREIGN_FIELDS``), an empty entry of the
reference's dtype and shape, so the JAX package's ``load`` reads it.
:func:`load` reads the JAX package's files: it takes the port's fields
and refuses a file that holds anything the port cannot carry, a
non-empty foreign entry or int32 event times (a time32 checkpoint).
"""

from __future__ import annotations

import json

import numpy as np

from .convert import FOREIGN_FIELDS, state_from_numpy, state_to_numpy
from .core import EngineConfig, SimState, resolve_device

__all__ = ["save", "load"]

_MANIFEST_KEY = "__madsim_manifest__"
_FORMAT = 11


def save(path: str, state: SimState, cfg: EngineConfig) -> None:
    """Write a batched SimState to ``path`` (.npz)."""
    arrays = state_to_numpy(state)
    widths = {
        "U": state.node_state.shape[2],
        "A": state.ev_args.shape[2],
        "W": state.ev_pay.shape[2],
    }
    n_seeds = state.seed.shape[0]
    for name, (dtype, shape, _item) in FOREIGN_FIELDS.items():
        arrays[name] = np.zeros((n_seeds, *(widths.get(d, d) for d in shape)), dtype)
    manifest = json.dumps(
        {
            "format": _FORMAT,
            "config_hash": cfg.hash(),
            "ev_time_dtype": str(arrays["ev_time"].dtype),
        }
    )
    arrays[_MANIFEST_KEY] = np.frombuffer(manifest.encode(), dtype=np.uint8)
    # through a file handle, so the path is used verbatim (np.savez on a
    # str would append .npz)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load(path: str, cfg: EngineConfig, device=None) -> SimState:
    """Load a SimState onto ``device`` (the card unless the caller asks
    for the CPU); refuse a checkpoint taken under another config, one
    with int32 event times, and one with a non-empty entry for a field
    the port does not carry."""
    dev = resolve_device(device)
    with np.load(path) as data:
        manifest = json.loads(bytes(data[_MANIFEST_KEY]).decode())
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"unknown checkpoint format {manifest.get('format')}")
        if manifest["config_hash"] != cfg.hash():
            raise ValueError(
                "checkpoint was taken under a different EngineConfig "
                f"({manifest['config_hash']} != {cfg.hash()}); resuming would "
                "silently change the simulation trajectory"
            )
        saved_dt = manifest.get("ev_time_dtype", str(data["ev_time"].dtype))
        if saved_dt != "int64" or data["ev_time"].dtype != np.int64:
            raise ValueError(
                f"checkpoint ev_time dtype is {saved_dt} (a time32 checkpoint); "
                "the torch port carries int64 absolute event times only: "
                "save it from a run built with time32=False"
            )
        for name, (_dtype, shape, item) in FOREIGN_FIELDS.items():
            if name not in data.files:
                continue
            a = data[name]
            # a per-seed counter is empty when zero, a column when it
            # has no entry past the seed axis
            if (a.size != 0) if shape else a.any():
                raise ValueError(
                    f"checkpoint field {name!r} is not empty (shape "
                    f"{a.shape}): the torch port does not carry it until "
                    f"ROADMAP item {item}"
                )
        return state_from_numpy(data, device=dev)
