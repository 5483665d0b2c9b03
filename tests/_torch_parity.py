"""Shared helper of the torch port's parity tests: per-field equality
of a port SimState with a JAX package SimState."""

import dataclasses

import numpy as np

import madsim_tpu.engine as je
from madsim_tpu_torch.engine.convert import state_to_numpy


def jax_fields(st) -> dict:
    return {
        f.name: np.asarray(getattr(st, f.name))
        for f in dataclasses.fields(je.SimState)
    }


def assert_same_state(jst, tst):
    """Every port field equals the reference's (values and dtypes); the
    reference's other fields are empty or zero for these workloads."""
    j, t = jax_fields(jst), state_to_numpy(tst)
    for name, v in t.items():
        assert j[name].dtype == v.dtype, name
        np.testing.assert_array_equal(v, j[name], err_msg=f"field {name}")
    for name in set(j) - set(t):
        assert j[name].size == 0 or not j[name].any(), name
