"""The closed loop, for mix files of `"kind": "closed"`: `clients`
callers, each sending its next request as soon as its last one has
been answered, with no think time.

    clients          callers, each a client of its own (its own id)
    mix              {program name: whole-number weight}
    pool_per_client  requests each client encrypts at set-up; one that
                     runs dry encrypts its next request on the spot
    stagger_groups   the clients start in this many groups, one fused
                     round apart, so that completions spread over rounds
    lead_rounds      fused rounds served before the window (set-up)

The traced segment of a `--trace 1` run follows the window under the
same load.

Each client is a thread that blocks on its answer, so the load
generator takes the interpreter's lock only when an answer comes.  Each
client runs its own shuffle of the mix's deck, cycled
(`generator.client_programs`), and every operand comes from the seed.
"""
import threading
import time

from perfbench import generator, harness


def drive(run, wl, drv, seed: int, t_start: float):
    """Serve the lead-in, then the window of `run.seconds`; set the
    window's ends, the set-up time and the counters on `run`; return the
    traced segment (or None) once every client has stopped."""
    traffic = run.traffic
    n = traffic["clients"]
    pool = traffic["pool_per_client"]
    streams, sent = [], [0] * n
    for c in range(n):
        reqs = [wl.make(c, name, ("closed", c, j))
                for j, name in enumerate(generator.client_programs(traffic, c, pool, seed))]
        wl.encrypt(reqs)
        streams.append(iter(reqs))
    answered = threading.Condition()
    last = [0.0]                    # the latest completion time
    stop = threading.Event()

    def next_req(c: int):
        req = next(streams[c], None)
        if req is None:               # the pool ran dry: encrypt on the spot
            name = generator.client_programs(traffic, c, sent[c] + 1, seed)[-1]
            req = wl.make(c, name, ("closed", c, sent[c]))
            with wl.lock:
                wl.refills += 1
                wl.encrypt([req])
        sent[c] += 1
        run.requests.append(req)
        return req

    def client(c: int) -> None:
        while not stop.is_set():
            req = next_req(c)
            drv.send(req)
            drv.finish(req)
            with answered:
                last[0] = max(last[0], req.done)
                answered.notify_all()

    def rounds() -> float:
        return drv.tel.counter("sched.fused_rounds").value

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(n)]
    groups = traffic["stagger_groups"]
    for g in range(groups):
        start = rounds()
        for c in range(g, n, groups):
            threads[c].start()
        while g < groups - 1 and rounds() == start:
            time.sleep(harness.POLL_S)
    target = rounds() + traffic["lead_rounds"]
    while rounds() < target:
        time.sleep(harness.POLL_S)

    def completion_after(t: float) -> float:
        """The first answer at or after `t`.  The window's ends fall on
        answers, so it holds whole rounds but for the stragglers of one
        round at each end (a round takes milliseconds; the window,
        seconds)."""
        with answered:
            answered.wait_for(lambda: last[0] >= t)
            return last[0]

    run.t0 = completion_after(time.perf_counter())
    run.setup_s = run.t0 - t_start
    c0 = drv.counters()
    run.t1 = completion_after(run.t0 + run.seconds)
    c1 = drv.counters()
    run.counters = {k: (c0.get(k, 0), c1[k]) for k in c1}
    profile = harness.profiled(run, time.sleep)
    stop.set()
    end = time.perf_counter() + harness.GRACE_S
    for t in threads:
        t.join(max(0.0, end - time.perf_counter()))
    return profile
