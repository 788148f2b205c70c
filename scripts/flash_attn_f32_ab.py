#!/usr/bin/env python3
"""Time the port's float32 flash_attn kernels (forward and backward) of
one source tree on the card, to compare two trees (or a tree and a
variant of it) in one call.

    python3 scripts/flash_attn_f32_ab.py SRC_DIR [--sdpa]

``SRC_DIR`` is the ``src`` directory of the tree: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``); a
variant is a copy of ``src`` under ``build/`` edited with ``sed``.  Run
the trees in turns in one call (parent, change, change, parent): two
calls may land on two cards.  For each of ``SHAPES`` (PERF.md section 6
rows 8r, BERT4Rec's attention, and 8f, the LM build's shape) it draws q,
k, v and dO in float32 with numpy from a fixed seed, takes o and lse
from the tree's forward kernel, and prints one JSON line: the device ms
per call of the forward and of each kernel of the backward and their sum
(CUPTI, 20 calls after 3 warm-up calls), the largest |diff| of each
against the tree's plain versions on the card and the share of the bar
(rtol 1e-4 / atol 1e-5) the worst value takes, and a digest of o and of
dQ, dK and dV (equal for equal code).  With ``--sdpa``, the forward and
backward of ``F.scaled_dot_product_attention`` in float32 (TF32 off) on
the same inputs beside them, each after 10 warm-up calls.  It prints the
card's name and power limit first and needs a CUDA device.
"""
import hashlib
import json
import re
import subprocess
import sys

# (B, S, Hq, Hkv, hd, causal): BERT4Rec's attention (rows 8r, 8rb) and
# the LM build's shape in float32 (row 8f)
SHAPES = ((256, 200, 2, 2, 32, False), (32, 512, 24, 8, 128, True))
ITERS = 20
WARMUP = 10


def events_ms(fn, iters, warmup=3):
    import torch
    for _ in range(warmup):
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


def cupti_ms(fn, pattern):
    """{kernel: device ms per call} of the kernels whose names match."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m and e.self_device_time_total > 0:
            out[m.group(0)] = e.self_device_time_total / 1e3 / ITERS
    return out


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--sdpa"]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, args[0])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_attn_f32_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels.flash_attn import (flash_attn_bwd_kernel,
                                                flash_attn_bwd_plain,
                                                flash_attn_kernel,
                                                flash_attn_plain)
    for b, s, hq, hkv, hd, causal in SHAPES:
        rng = np.random.RandomState(b * s + hq + hd)
        q, do = (torch.from_numpy(rng.standard_normal((b, s, hq, hd)).astype(
            np.float32)).cuda() for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, hd)).astype(
            np.float32)).cuda() for _ in range(2))
        o, lse = flash_attn_kernel(q, k, v, causal=causal, return_lse=True)
        grads = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)
        want_o = flash_attn_plain(q, k, v, causal=causal)
        want = flash_attn_bwd_plain(q, k, v, o, do, lse, causal=causal)
        errs, used = {}, {}
        for name, a, w in zip(("o", "dq", "dk", "dv"), (o,) + grads,
                              (want_o,) + want):
            d = (a - w).abs()
            errs[name] = d.max().item()
            used[name] = (d / (1e-5 + 1e-4 * w.abs())).max().item()
        fwd = cupti_ms(lambda: flash_attn_kernel(q, k, v, causal=causal),
                       r"flash_attn_kernel\w*")
        bwd = cupti_ms(lambda: flash_attn_bwd_kernel(
            q, k, v, o, do, lse, causal=causal), r"flash_attn_bwd_\w+")
        row = {"src": args[0], "shape": [b, s, hq, hkv, hd, causal],
               "fwd_ms": sum(fwd.values()), "fwd_kernels_ms": fwd,
               "bwd_ms": sum(bwd.values()), "bwd_kernels_ms": bwd,
               "max_abs_err": errs, "share_of_bar": used,
               "digest_o": digest([o]), "digest_grads": digest(grads)}
        if "--sdpa" in sys.argv:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            row["sdpa_fwd_ms"] = events_ms(
                lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True),
                ITERS, WARMUP)
            out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            row["sdpa_bwd_ms"] = events_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), ITERS, WARMUP)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
