"""Render dryrun_results.json into the roofline tables: the port of
`repro.launch.report`.

    python -m repro_torch.launch.report build/dryrun_results.json

The numbers are the dry run's analytic counts (`launch.dryrun`), not
measurements.
"""
from __future__ import annotations

import json
import sys


def fmt_table(rows, mesh):
    out = []
    out.append(f"\n### Mesh {mesh}\n")
    out.append("| arch | shape | Tc (s) | Tm pess (s) | Tm fused (s) | "
               "Tcoll (s) | bottleneck | mfu ≤ (pess..fused) | useful | "
               "GiB/dev | collectives |")
    out.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r["mesh"] != mesh:
            continue
        coll = ", ".join(f"{k.split('-')[0]}:{v / 1e9:.1f}GB"
                         for k, v in sorted(r["coll_breakdown"].items(),
                                            key=lambda kv: -kv[1])[:3])
        gib = (r["arg_bytes"] + r["temp_bytes"]) / 2 ** 30
        tmm = r.get("t_memory_major_s", 0.0)
        mfum = r.get("mfu_bound_major", 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.2e} | "
            f"{r['t_memory_s']:.2e} | {tmm:.2e} | "
            f"{r['t_collective_s']:.2e} | "
            f"{r['bottleneck']} | {r['mfu_bound']:.3f}..{mfum:.3f} | "
            f"{r['flops_ratio']:.2f} | {gib:.1f} | {coll} |")
    return "\n".join(out)


def main(path="dryrun_results.json"):
    d = json.load(open(path))
    rows = d["results"]
    print(f"{len(rows)} cells, {len(d['failures'])} failures")
    for mesh in ("16x16", "2x16x16"):
        print(fmt_table(rows, mesh))


if __name__ == "__main__":
    main(*sys.argv[1:])
