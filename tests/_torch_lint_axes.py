"""The small campaigns of the port's lint-axes tests
(``tests/test_torch_lint_axes.py`` and the gloo world of
``tests/_torch_world.py``), in either package's classes: raft-record
under a crash storm judged by election safety on the device, and the
kvchaos client army under a crash storm judged by ``halted``."""

RAFT_CASE = dict(generations=2, batch=16, root_seed=5, max_steps=120)
ARMY_CASE = dict(generations=1, batch=8, root_seed=3, max_steps=80, perturb_seeds=(1,))
NODES = (0, 1, 2, 3, 4)


def _modules(port: bool):
    if port:
        import madsim_tpu_torch.chaos as ch
        import madsim_tpu_torch.models as m
        from madsim_tpu_torch.check import device as dc
        from madsim_tpu_torch.engine import EngineConfig
    else:
        import madsim_tpu.chaos as ch
        import madsim_tpu.models as m
        from madsim_tpu.check import device as dc
        from madsim_tpu.engine import EngineConfig
    return ch, m, dc, EngineConfig


def raft_case(port: bool = True):
    """``(workload, config, plan, judge)``: raft-record at its lint
    config under a crash storm; ``judge`` the campaign's
    ``history_check`` (election safety on the device)."""
    ch, m, dc, cfg = _modules(port)
    plan = ch.FaultPlan((ch.CrashStorm(targets=NODES, n=1, t_min_ns=20_000_000,
                                       t_max_ns=300_000_000),), name="lint-axes-raft")
    return (m.make_raft(record=True),
            cfg(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000), plan,
            dict(history_check=(dc.election_safety(m.raft.OP_ELECT),)))


def halted(v):
    """A final-state invariant of either package: the seed halted."""
    return v["halted"]


def army_case(port: bool = True):
    """``(workload, config, plan, judge)``: the kvchaos client army at its
    lint config under its army and a crash storm; ``judge`` the
    campaign's ``invariant`` (``halted``)."""
    ch, m, _dc, cfg = _modules(port)
    plan = ch.FaultPlan((m.kvchaos.client_army(n_ops=8),
                         ch.CrashStorm(targets=(1, 2, 3), n=1, t_min_ns=20_000_000,
                                       t_max_ns=300_000_000)), name="lint-axes-army")
    return (m.make_kvchaos(army=True),
            cfg(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000), plan,
            dict(invariant=halted))
