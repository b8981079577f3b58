"""The benchmark of `repro_torch`, the PyTorch and CUDA port of Taurus:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json on the card of this machine and prints,
as its last line, one JSON object: `correct`, `attempted`, `failed`, the
cell's end-to-end metrics (`--trace 0`) or per-layer metrics (`--trace
1`), the device, and the numbers compared with their limits.  It exits
with another code than 0, printing no result, without a CUDA card, or
if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # the program's build caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    import torch
    from perfbench import harness
    spec = harness.cell_spec(args.workload, ROOT)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              root=ROOT, device="cuda", t_start=T_START, spec=spec)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"run.py: the run loaded {loaded}; the port must not", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    if threading.active_count() > 1:
        # a request never served leaves its worker running inside the
        # program; the result is out, so end without waiting for it
        sys.stderr.flush()
        os._exit(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
