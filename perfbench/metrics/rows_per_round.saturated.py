"""Rows a fused round dispatches, after dedup and before padding:
`sched.dispatched_luts` over `sched.fused_rounds`, across the window."""


def read(run):
    rounds = run.delta("sched.fused_rounds")
    return run.delta("sched.dispatched_luts") / rounds if rounds else None
