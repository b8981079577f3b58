"""One run of one cell: set up a Taurus server of the port on the
client's keys, drive the cell's traffic through `ServeRuntime.submit`
for the measured window, then check every answer and read the metrics.

Everything that belongs to a configuration, a traffic mix, a program or
a metric is found by name: `configs/<config>.json`, `traffic/<mix>.json`
(whose `kind` names the loop that drives it, `traffic/<kind>.py`),
`programs/<program>.py`, `metrics/<metric>.py`.  The benchmark plays the
clients (keys, encryption, decryption and the plaintext semantics, in
`client.py` and the program files); the port plays the server.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from perfbench import client, generator
from perfbench.counts import pbs as counts

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
POLL_S = 0.002              # how often set-up looks at the round counter
ENCRYPT_ROWS = 4096          # ciphertexts per encryption call
PROFILE_S = 3.0             # the traced segment after the window (--trace 1)
GRACE_S = 60.0              # how long a request may take to be answered after
                            # the traffic stops before it counts as unserved


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration and traffic files, and the
    metrics BENCHMARK.json lists for it."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    return {"cell": cell, "config_name": conf["name"],
            "config": load_json(root / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_program(name: str):
    return importlib.import_module(f"perfbench.programs.{name}")


def load_file(folder: str, name: str):
    """The module `<folder>/<name>.py`; a name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{name.replace('.', '_').replace('-', '_')}", HERE / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Req:
    """One request: what the client sent and what came back."""
    idx: int
    client: int
    program: str
    values: list
    enc: Optional[list] = None
    sent: Optional[float] = None
    done: Optional[float] = None
    handle: object = None
    outputs: Optional[list] = None
    error: Optional[str] = None
    pbs: int = 0

    @property
    def served(self) -> bool:
        return self.done is not None and self.error is None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    params: client.Params
    config: dict
    traffic: dict
    seconds: float
    t0: float = 0.0
    t1: float = 0.0
    setup_s: float = 0.0
    requests: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)   # name -> (at t0, at t1)
    spans: list = dataclasses.field(default_factory=list)
    trace_on: bool = False            # a --trace 1 run on the card
    trace: object = None              # profiling.DeviceTrace of the traced segment
    peaks: object = None

    def delta(self, name: str) -> float:
        a, b = self.counters[name]
        return b - a

    def window_requests(self) -> list:
        """Requests sent in the window."""
        return [r for r in self.requests if r.sent is not None and self.t0 <= r.sent < self.t1]


class Sender:
    """Submits requests and waits for their answers; any thread may call
    it (a closed loop sends from one thread per client)."""

    def __init__(self, rt, programs: dict, telemetry):
        self.rt = rt
        self.programs = programs
        self.tel = telemetry

    def counters(self) -> dict:
        """Every counter the program's telemetry holds, by name."""
        return dict(self.tel.registry.snapshot()["counters"])

    def send(self, req: Req) -> None:
        req.sent = time.perf_counter()
        req.handle = self.rt.submit(self.programs[req.program][1].graph, req.enc,
                                    client_id=f"client-{req.client}")

    def finish(self, req: Req, timeout: Optional[float] = None) -> bool:
        """Block until the request's answer is in (or `timeout` passes);
        returns whether it came."""
        try:
            req.handle.wait(timeout)
        except Exception as err:  # noqa: BLE001 — recorded and judged
            if not req.handle.done():
                return False
            req.error = repr(err)
        else:
            req.outputs = req.handle.outputs()
        req.done = time.perf_counter()
        req.enc, req.handle = None, None
        return True


class Workload:
    """The cell's requests, made from the seed and encrypted at set-up."""

    def __init__(self, spec: dict, programs: dict, keys: client.ClientKeys,
                 gen: torch.Generator, seed: int):
        self.programs, self.keys, self.gen = programs, keys, gen
        self.config, self.traffic, self.seed = spec["config"], spec["traffic"], seed
        self.next_idx = 0
        self.refills = 0
        self.lock = threading.Lock()

    def make(self, client_idx: int, program: str, label) -> Req:
        mod = self.programs[program][0]
        values = mod.sample(generator.seeded_rng("values", self.seed, label), self.config)
        with self.lock:
            req = Req(self.next_idx, client_idx, program, values, pbs=mod.PBS)
            self.next_idx += 1
        return req

    def encrypt(self, reqs: list) -> None:
        """Every request's inputs in large encryption calls."""
        rows, flat = [], []
        for r in reqs:
            msgs = self.programs[r.program][0].input_messages(r.values, self.config)
            rows.append([len(m) for m in msgs])
            flat += [x for m in msgs for x in m]
        cts = [client.encrypt(self.keys, self.gen, flat[i:i + ENCRYPT_ROWS])
               for i in range(0, len(flat), ENCRYPT_ROWS)]
        cts = torch.cat(cts) if len(cts) > 1 else cts[0]
        at = 0
        for r, sizes in zip(reqs, rows):
            r.enc = []
            for s in sizes:
                r.enc.append(cts[at:at + s])
                at += s


def build_server(spec: dict, keys: client.ClientKeys, device, trace: bool,
                 engine_hook: Optional[Callable]):
    """The port's server on the client's evaluation keys: a TFHEContext
    holding no secret key, and a `ServeRuntime` over it."""
    from repro_torch.core.ggsw import bsk_to_fourier
    from repro_torch.core.params import TFHEParams
    from repro_torch.core.pbs import TFHEContext
    from repro_torch.obs import Telemetry
    from repro_torch.serve import ServeRuntime
    params = TFHEParams(name=spec["config_name"], **spec["config"]["params"])
    none = torch.empty(0, dtype=torch.int64, device=device)
    ctx = TFHEContext(params, lwe_sk=none, glwe_sk=none, big_sk=none,
                      bsk_f=bsk_to_fourier(keys.bsk), ksk=keys.ksk)
    tel = Telemetry(trace=trace)
    rt = ServeRuntime(ctx, telemetry=tel, **spec["config"]["server"])
    if engine_hook is not None:
        engine_hook(rt.engine, keys)
    return rt, tel


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device=None, t_start: Optional[float] = None,
             spec: Optional[dict] = None, engine_hook: Optional[Callable] = None,
             log=None, keep: Optional[dict] = None) -> dict:
    """One run; returns the result object the command prints (and puts
    the `Run` under keep["run"] when given a dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec = spec or cell_spec(workload, root)
    config, traffic = spec["config"], spec["traffic"]
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    p = client.Params(**config["params"])
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = client.keygen(p, gen)
    rt, tel = build_server(spec, keys, device, trace, engine_hook)
    keys.bsk = None
    if on_card and getattr(rt.engine, "kernel_backend", "") == "fused":
        rt.engine.fused_pack                        # the resident key operands
    programs = {}
    for name in generator.deck(traffic["mix"]):
        mod = load_program(name)
        programs[name] = (mod, mod.build(config))
    enc_gen = torch.Generator(device=device).manual_seed(
        generator.seeded_rng("encrypt", seed).getrandbits(62))
    wl = Workload(spec, programs, keys, enc_gen, seed)
    drv = Sender(rt, programs, tel)
    run = Run(p, config, traffic, seconds, trace_on=trace and on_card,
              peaks=counts.card_peaks(torch.cuda.get_device_name(device)) if on_card else None)
    # one request of each program, alone, before any load: the kernels
    # build (first run in a checkout) and load here, not under the load
    warm = [wl.make(-1, name, ("warm", name)) for name in sorted(programs)]
    wl.encrypt(warm)
    for r in warm:
        drv.send(r)
        drv.finish(r)
    run.requests += warm
    # the loop returns once every request it sent is answered, or
    # GRACE_S after the window's traffic stopped
    profile = load_file("traffic", traffic["kind"]).drive(run, wl, drv, seed, t_start)
    unserved = [r for r in run.requests if r.sent is not None and r.done is None]
    for r in unserved:
        r.error = "never served"
    if not unserved:
        rt.close()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if trace:
        run.spans = tel.recorder.spans()
    run.trace = profile
    del rt, drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    window = run.window_requests()
    mix = {n: sum(r.program == n for r in window) for n in sorted(programs)}
    log(f"run: {len(window)} requests in the {run.t1 - run.t0:.3f} s window {mix}, "
        f"{len(run.requests)} in all, setup {run.setup_s:.3f} s; in the window "
        + ", ".join(f"{k} {run.delta(k):.0f}" for k in sorted(run.counters)
                    if k.startswith("sched."))
        + f"; pool refills {wl.refills}")
    checks, compared = check(run, keys, programs, config, log)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = load_file("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(not r.served for r in window)
    correct = (compared > 0 and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else str(device),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.wall_s
        result["breakdown"] = {"device_ops": profile.device_ops(),
                               "idle_gaps": profile.idle_gaps()}
    log(f"check: {compared} requests compared")
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    result["checks"] = checks
    if keep is not None:
        keep["run"] = run
    return result


def profiled(run: Run, serve_for: Callable):
    """Serve on for the traced segment under the profiler (trace runs on
    the card only); returns the segment's DeviceTrace or None."""
    if not run.trace_on:
        return None
    from perfbench.profiling import Profiled
    with Profiled() as prof:
        serve_for(PROFILE_S)
    return prof.trace


def check(run: Run, keys: client.ClientKeys, programs: dict, config: dict, log=None):
    """Decrypt every served request's outputs with the client's key and
    hold them to the program's plaintext semantics.  Returns the numbers
    compared, each with its limit, and how many requests were compared;
    logs the first requests that came back wrong."""
    limits = config["checks"]
    served = [r for r in run.requests if r.served]
    cts, want, owner = [], [], []
    for r in served:
        exp = programs[r.program][0].expected_messages(r.values, config)
        for out, msgs in zip(r.outputs, exp):
            cts.append(out)
            want += msgs
            owner += [r] * len(msgs)
    got, share = [], []
    flat = torch.cat(cts) if cts else torch.empty(0)
    for i in range(0, flat.shape[0], ENCRYPT_ROWS):
        block = flat[i:i + ENCRYPT_ROWS]
        msgs, ph = client.decrypt(keys, block)
        got += msgs.tolist()
        share += client.noise_share(keys, ph, want[i:i + block.shape[0]]).tolist()
    bad = {}
    for r, g, w in zip(owner, got, want):
        if g != w:
            bad.setdefault(id(r), r)
    for r in list(bad.values())[:10]:
        exp = programs[r.program][0].expected_messages(r.values, config)
        dec = client.decrypt(keys, torch.cat(r.outputs))[0].tolist()
        (log or print)(f"wrong: {r.program} {r.values} decrypts {dec}, want {exp}; sent "
                       f"{r.sent - run.t0:+.3f} s, done {r.done - run.t0:+.3f} s from the window's start")
    unserved = sum(1 for r in run.requests if r.sent is not None and not r.served)
    checks = {"unserved_requests": {"value": unserved, "limit": 0},
              "wrong_outputs": {"value": sum(g != w for g, w in zip(got, want)),
                                "limit": limits["wrong_outputs"]},
              "worst_noise_share": {"value": max(share, default=0.0),
                                    "limit": limits["worst_noise_share"]}}
    return checks, len(served)
