#!/usr/bin/env python3
"""Where the 1 x 1 mesh's serving time goes, on the card.

    python3 scripts/mesh_serving_ab.py [--rounds 3]

Builds ``chip_smoke.py``'s phase 1 index and its 16 requests (6 slots x
1,000 candidates), then times ``serve_batches`` p50 per request in this
order, each over the same device arrays: the mesh-less engine before any
process group exists; the same after ``make_host_mesh(1, 1)`` started
NCCL; the meshed engine (single CSR) with its collectives; the meshed
engine with the collectives replaced by no-ops (the same arithmetic,
bitwise: one rank's sum and gather are the identity); the mesh-less
engine after a ``torch.profiler`` capture.  Each is run ``--rounds``
times in turn.  Prints one line per measurement and the card's name and
power limit.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.dist import collective  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, release_world  # noqa: E402
from repro_torch.serving import SeineEngine, serve_batches  # noqa: E402


def p50(engine, requests, want=None) -> float:
    serve_batches(engine, requests[:2])
    scores, st = serve_batches(engine, requests)
    if want is not None and not all(np.array_equal(a, b)
                                    for a, b in zip(scores, want)):
        raise AssertionError("scores differ from the mesh-less engine's")
    return st.p50_ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_serving_ab: needs the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, flush=True)
    dev = torch.device("cuda")
    cs.build_all()
    index, rng = cs.build_index(0, dev)
    params = cs.get_retriever("knrm").init(
        torch.Generator().manual_seed(0), cs.N_B, index.functions,
        device=dev)
    requests = [(cs.draw_query(rng, rng.randint(3, cs.Q_SLOTS + 1)),
                 rng.choice(cs.N_DOCS, cs.N_CAND, replace=False)
                 .astype(np.int32)) for _ in range(cs.N_REQUESTS)]
    plain = SeineEngine(index, "knrm", params)
    want, _ = serve_batches(plain, requests)
    rows = {"mesh-less, no process group": [p50(plain, requests)
                                            for _ in range(args.rounds)]}
    mesh = make_host_mesh(1, 1)
    try:
        meshed = SeineEngine(index, "knrm", params, mesh=mesh)
        no_coll = SeineEngine(index, "knrm", params, mesh=mesh)
        for _ in range(args.rounds):
            for name, eng, patch in (
                    ("mesh-less, NCCL world started", plain, False),
                    ("meshed (single CSR)", meshed, False),
                    ("meshed, collectives as no-ops", no_coll, True)):
                saved = (sharding.Placement.merge,
                         sharding.NamedSharding.gather)
                if patch:
                    sharding.Placement.merge = lambda self, m: m
                    sharding.NamedSharding.gather = lambda self, t: t
                try:
                    rows.setdefault(name, []).append(
                        p50(eng, requests, want))
                finally:
                    (sharding.Placement.merge,
                     sharding.NamedSharding.gather) = saved
        n = collective.all_reduce_sum.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            serve_batches(meshed, requests[:4])
            torch.cuda.synchronize()
        nccl = {e.key: round(e.device_time_total / 1e3, 4)
                for e in prof.key_averages() if "nccl" in e.key.lower()}
        rows["mesh-less, after a profiler capture"] = [
            p50(plain, requests) for _ in range(args.rounds)]
    finally:
        release_world()
    for name, ms in rows.items():
        print(f"{card}: {name}: p50 ms per request "
              f"{', '.join(f'{m:.3f}' for m in ms)}")
    print(f"{card}: NCCL entries in a 4-request capture (device ms): "
          f"{nccl}; all_reduce calls before it {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
