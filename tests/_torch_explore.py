"""Shared helper of the torch port's explore tests: the plans, configs
and invariants of the JAX package's ``tests/test_explore.py`` and
``tests/test_explore_device.py``, in either package's classes, and the
campaign fingerprint both files hold the port to."""

import numpy as np

NODES = (0, 1, 2, 3, 4)


def raft_plan(ch, name="raft-explore-test"):
    """The pause-storm and gray-failure space of the JAX explore tests."""
    return ch.FaultPlan((
        ch.PauseStorm(targets=NODES, n=1, t_min_ns=20_000_000, t_max_ns=300_000_000,
                      down_min_ns=50_000_000, down_max_ns=200_000_000),
        ch.GrayFailure(targets=NODES, n_links=1),
    ), name=name)


def every_mode_plan(ch):
    """A plan space with every retarget mode: node (crash, disk fault),
    pair (partitions), slow (gray failure), skew and the retime fallback
    (duplication, a client army)."""
    return ch.FaultPlan((
        ch.CrashStorm(targets=(1, 2, 3), n=2),
        ch.Partition(targets=(0, 1, 2), asymmetric=True, partial_p=0.7),
        ch.FlappingPartition(targets=(1, 2, 3), n_cycles=2),
        ch.GrayFailure(targets=NODES, n_links=2),
        ch.Duplicate(),
        ch.ClockSkew(targets=(0, 1, 2)),
        ch.DiskFault(targets=(2, 4), n_torn=1, n_eio=1),
        ch.ClientArmy(node=1, kind=11, n_ops=3, t_min_ns=5_000_000, t_max_ns=90_000_000),
    ), name="every-mode")


def kv_plan(ch):
    """The JAX explore test's kvchaos crash storm."""
    return ch.FaultPlan((
        ch.CrashStorm(targets=(1, 2, 3, 4), n=2, down_min_ns=50_000_000,
                      down_max_ns=250_000_000),
    ), name="kv-explore-test")


def halt_inv(view):
    # a predicate over numpy (host driver) and tensor (device driver)
    # views alike
    return view["halted"]


def biased_inv(view):
    # a deterministic "bug" of the final state: seeds whose trace hash
    # lands in the low eighth violate
    return (view["trace"] & 7) != 0


def fingerprint(rep):
    """Everything a campaign decides: the corpus entries, the coverage
    map, the violations and both curves."""
    return (
        [(e.id, e.generation, e.parent, int(e.seed), e.plan.name, e.plan.hash(),
          int(e.trace), e.new_bits, e.violating, e.halt_t) for e in rep.corpus],
        np.asarray(rep.cov_map, np.uint32).tolist(),
        [(int(e.seed), int(e.trace)) for e in rep.violations],
        list(rep.curve),
        list(rep.viol_curve),
    )
