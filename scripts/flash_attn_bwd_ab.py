#!/usr/bin/env python3
"""Time the port's flash_attn backward kernel of one source tree on the
card, to compare two trees (or a tree and a variant of it) in one call.

    python3 scripts/flash_attn_bwd_ab.py SRC_DIR [--sdpa]

``SRC_DIR`` is the ``src`` directory of the tree: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``); a
variant is a copy of ``src`` under ``build/`` edited with ``sed``.  Run
the trees in turns in one call (parent, change, change, parent): two
calls may land on two cards.  For each of ``SHAPES`` (``chip_smoke.py``
phase 12's ``FA_BWD_SHAPES``) it draws q, k, v and dO in bf16 with numpy
from a fixed seed, takes o and lse from the tree's forward kernel, and
prints one JSON line: the device ms per call of each kernel the call
launches and their sum (CUPTI, 20 calls after 3 warm-up calls), the ms
per call with launch cost (CUDA events), the TFLOP/s against the
function's 10 hd flops per attended pair and against the bf16 design's
20 hd, and a digest of dQ, dK and dV (equal for equal code).  With
``--sdpa``, the backward of ``F.scaled_dot_product_attention``
(``enable_gqa``) on the same inputs beside it.  It prints the card's
name and power limit first and needs a CUDA device.
"""
import hashlib
import json
import re
import subprocess
import sys

# (B, S, Hq, Hkv, hd, causal): chip_smoke.py's FA_BWD_SHAPES
SHAPES = ((16, 1024, 32, 32, 64, True), (8, 1024, 24, 8, 64, True),
          (4, 1024, 24, 8, 128, True), (1, 1000, 8, 2, 64, True),
          (1, 1000, 8, 2, 64, False))
ITERS = 20


def events_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--sdpa"]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, args[0])
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("flash_attn_bwd_ab: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels.flash_attn import (flash_attn_bwd_kernel,
                                                flash_attn_kernel)
    for b, s, hq, hkv, hd, causal in SHAPES:
        rng = np.random.RandomState(b * s + hq + hd)
        q, do = (torch.from_numpy(rng.standard_normal((b, s, hq, hd)).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, hd)).astype(
            np.float32)).to("cuda", torch.bfloat16) for _ in range(2))
        o, lse = flash_attn_kernel(q, k, v, causal=causal, return_lse=True)

        def call():
            return flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)

        h = hashlib.sha256()
        for g in call():
            h.update(g.view(torch.int16).cpu().numpy().tobytes())
        call_ms = events_ms(call, ITERS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                call()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            m = re.search(r"flash_attn_bwd_\w+", e.key)
            if m:
                kernels[m.group(0)] = e.self_device_time_total / 1e3 / ITERS
        ms = sum(kernels.values())
        pairs = b * hq * (s * (s + 1) / 2 if causal else s * s)
        row = {"src": args[0], "shape": [b, s, hq, hkv, hd, causal],
               "ms": ms, "kernels_ms": kernels, "call_ms": call_ms,
               "tflops_10hd": 10 * hd * pairs / ms / 1e9 if ms else None,
               "tflops_20hd": 20 * hd * pairs / ms / 1e9 if ms else None,
               "digest": h.hexdigest()[:16]}
        if "--sdpa" in sys.argv:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            row["sdpa_ms"] = events_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), ITERS)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
