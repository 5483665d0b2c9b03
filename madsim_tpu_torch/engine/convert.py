"""State carried between the JAX package and the port.

The engine's state is its "weights": these two functions move a
``SimState`` across, field by field, with the JAX package's dtypes on
the numpy side (uint64 seed and trace, uint32 step and meta), so a JAX
state can be stepped by the port and the port's output can be handed
to the JAX package's own checkers (``compare_traces``, ``np.array_equal``
per field). Every field of the JAX package's ``SimState`` travels but
the pool-index summaries (``tile_min``, ``tile_cnt``), which are derived
state and travel in no file.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import STATE_FIELDS, SimState, Workload

__all__ = [
    "NUMPY_DTYPES",
    "field_to_numpy",
    "state_from_numpy",
    "state_to_numpy",
    "tables_from_numpy",
    "tables_to_numpy",
]

# the JAX package's dtype of every core field
NUMPY_DTYPES = {
    "seed": np.uint64,
    "now": np.int64,
    "step": np.uint32,
    "halted": np.bool_,
    "halt_time": np.int64,
    "trace": np.uint64,
    "overflow": np.int32,
    "msg_count": np.int64,
    "ev_time": np.int64,
    "ev_valid": np.bool_,
    "ev_meta": np.uint32,
    "ev_epoch": np.int32,
    "ev_args": np.int32,
    "ev_pay": np.int32,
    "alive": np.bool_,
    "paused": np.bool_,
    "epoch": np.int32,
    "node_state": np.int32,
    "clog": np.bool_,
    "slow": np.int32,
    "dup": np.bool_,
    "skew": np.int32,
    "disk": np.int32,
    "wmask": np.bool_,
    "sync_loss": np.bool_,
    "sync_eio": np.bool_,
    "torn": np.bool_,
    "hist_count": np.int32,
    "hist_drop": np.int32,
    "hist_word": np.int32,
    "hist_t": np.int64,
    "met": np.int32,
    "cov": np.uint32,
    "cov_last": np.int32,
    "cov_hits": np.uint8,
    "tl_count": np.int32,
    "tl_drop": np.int32,
    "tl_t": np.int64,
    "tl_meta": np.uint32,
    "tl_args": np.int32,
    "tl_pay": np.int32,
    "ev_emit": np.int64,
    "tl_emit": np.int64,
    "lam": np.uint32,
    "ev_parent": np.int32,
    "ev_lam": np.uint32,
    "tl_seq": np.int32,
    "tl_parent": np.int32,
    "tl_lam": np.uint32,
    "lat_inv": np.int64,
    "lat_resp": np.int64,
    "lat_hist": np.int32,
    "lat_count": np.int32,
    "lat_drop": np.int32,
    "rt_done": np.bool_,
    "rt_attempt": np.int32,
    "rt_deadline": np.int64,
}

# the port's torch dtype of every core field
_TORCH_DTYPES = {
    np.uint64: torch.int64,
    np.uint32: torch.int64,
    np.int64: torch.int64,
    np.int32: torch.int32,
    np.uint8: torch.uint8,
    np.bool_: torch.bool,
}


def state_from_numpy(fields: dict, device="cpu") -> SimState:
    """A port state from the JAX package's fields as numpy arrays
    (extra keys are ignored). uint64 words keep their bit pattern in
    int64; uint32 words widen to int64."""
    out = {}
    for name in STATE_FIELDS:
        want = NUMPY_DTYPES[name]
        a = np.asarray(fields[name])
        if a.dtype != want:
            raise TypeError(
                f"field {name!r} has dtype {a.dtype}, expected "
                f"{np.dtype(want).name}"
            )
        if want is np.uint64:
            a = a.view(np.int64)
        elif want is np.uint32:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.array(a, copy=True))
        out[name] = t.to(device=device, dtype=_TORCH_DTYPES[want])
    return SimState(**out)


def field_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    """One port field as numpy with the JAX package's dtype."""
    a = t.detach().cpu().numpy()
    want = NUMPY_DTYPES[name]
    return a.view(np.uint64) if want is np.uint64 else a.astype(want)


def state_to_numpy(state: SimState) -> dict:
    """The port's state as numpy arrays with the JAX package's dtypes."""
    return {name: field_to_numpy(name, getattr(state, name)) for name in STATE_FIELDS}


def tables_to_numpy(wl: Workload) -> tuple:
    """The workload's restart tables as the JAX package holds them:
    ``(initial_state() (N,U) int32, volatile_mask() (U,) bool)``."""
    return (
        np.asarray(wl.initial_state(), np.int32),
        np.asarray(wl.volatile_mask(), np.bool_),
    )


def tables_from_numpy(init_rows, volatile, device="cpu") -> tuple:
    """The two restart tables as torch tensors (int32 and bool)."""
    return (
        torch.as_tensor(np.asarray(init_rows, np.int32), device=device),
        torch.as_tensor(np.asarray(volatile, np.bool_), device=device),
    )
