"""The device's time for a fused round, in ms: the mean `device_ms` (two
CUDA events, before the round's gather and after its inverse gather) of
the window's `fused_round` spans."""
from perfbench.metrics import spans


def read(run):
    ms = [s.args["device_ms"] for s in spans.in_window(run, "fused_round")
          if "device_ms" in s.args]
    return sum(ms) / len(ms) if ms else None
