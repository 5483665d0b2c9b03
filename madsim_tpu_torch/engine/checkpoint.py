"""Checkpoint and resume of batched simulation state.

Port of ``madsim_tpu/engine/checkpoint.py``, in its file format 11: one
``.npz`` with an entry per ``SimState`` field, in the JAX package's
dtypes, and a manifest entry recording the format, the config hash
(resuming under another config would silently change the trajectory)
and the event-time dtype. A checkpoint plus its (workload, config)
resumes to the same trajectory as the uninterrupted run.

The files cross both ways: the port's ``SimState`` has every field of
the JAX package's but the pool-index summaries, which are derived and
travel in no file. :func:`load` refuses a file with int32 event times
(a time32 checkpoint) and one whose retry columns do not match the
resumed run's policy.
"""

from __future__ import annotations

import json

import numpy as np

from .convert import state_from_numpy, state_to_numpy
from .core import EngineConfig, SimState, resolve_device, retry_width

__all__ = ["save", "load"]

_MANIFEST_KEY = "__madsim_manifest__"
_FORMAT = 11


def save(path: str, state: SimState, cfg: EngineConfig) -> None:
    """Write a batched SimState to ``path`` (.npz)."""
    arrays = state_to_numpy(state)
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


def load(path: str, cfg: EngineConfig, device=None, retry=None) -> SimState:
    """Load a SimState onto ``device`` (the card unless the caller asks
    for the CPU); refuse a checkpoint taken under another config and one
    with int32 event times.

    ``retry``: the ``RetrySpec`` the resumed run will use, or None for a
    run without a policy. The retry columns are core state (an armed
    deadline is history), so a checkpoint whose saved ``rt_done`` width
    differs from ``retry.n_ops`` is refused, either way round."""
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
        state = state_from_numpy(data, device=dev)
    saved_ops = retry_width(state)
    want_ops = 0 if retry is None else int(retry.n_ops)
    if saved_ops != want_ops:
        raise ValueError(
            f"checkpoint carries retry columns for {saved_ops} ops but the "
            f"resumed run declared "
            f"{'no retry policy' if retry is None else f'retry.n_ops={want_ops}'}"
            "; armed retry deadlines are core state, so resume with the "
            "checkpoint's own RetrySpec (or an off-policy checkpoint "
            "off-policy) — pass the matching retry= here and to "
            "make_run/make_run_while/make_run_compacted"
        )
    return state
