"""Render the dry run's tables from its JSON records (port of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--dir dryrun_results_torch]

Reads either package's records, one-card (``card``) and mesh
(``single``, ``multi``) records alike; ``--mesh`` picks the roofline
table's.  A cell the port only counted (not stepped on the card, or
counted on a mesh) has no peak, compile seconds or temp bytes: those
cells show ``-``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional


def load(dirname: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        parts = os.path.basename(f)[:-5].split("__")
        r["_variant"] = parts[3] if len(parts) > 3 else "baseline"
        out.append(r)
    return out


def fmt_b(x: Optional[float]) -> str:
    if x is None:
        return "-"
    for unit, k in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(x) >= k:
            return f"{x/k:.1f}{unit}"
    return f"{x:.0f}B"


def _or_dash(x, fmt: str) -> str:
    return "-" if x is None else format(x, fmt)


def roofline_table(recs: List[Dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | variant | peak GiB/dev | t_compute | t_memory "
        "| t_collective | bottleneck | roofline frac | useful flops |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        rl = r["roofline"]
        frac = rl["t_compute_s"] / rl["t_bound_s"] if rl["t_bound_s"] else 0
        u = r.get("useful_flops_ratio")
        us = f"{u:.2f}" if u else "-"
        variant = r.get("_variant", "baseline")
        if variant == "opt":
            variant = "optimized"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {variant} | "
            f"{_or_dash(r['memory']['peak_gib_per_device'], '.2f')} | "
            f"{rl['t_compute_s']:.3e} | {rl['t_memory_s']:.3e} | "
            f"{rl['t_collective_s']:.3e} | {rl['bottleneck']} | "
            f"{frac*100:.1f}% | {us} |")
    return "\n".join(lines)


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | devices | compile s | args/dev | temp/dev "
        "| collectives |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        coll = r["roofline"]["coll_by_op"]
        ops = ", ".join(f"{k}:{fmt_b(v)}" for k, v in sorted(coll.items())
                        if k != "total" and v > 0)
        compile_s = "-" if r["compile_s"] is None else r["compile_s"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['n_devices']} "
            f"| {compile_s} | "
            f"{fmt_b(r['memory']['argument_bytes_per_device'])} | "
            f"{fmt_b(r['memory']['temp_bytes_per_device'])} | {ops} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="dryrun_results_torch")
    ap.add_argument("--what", default="roofline",
                    choices=["roofline", "dryrun"])
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi"])
    args = ap.parse_args()
    recs = load(args.dir)
    if args.what == "roofline":
        print(roofline_table(recs, args.mesh))
    else:
        print(dryrun_table(recs))


if __name__ == "__main__":
    main()
