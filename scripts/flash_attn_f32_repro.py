#!/usr/bin/env python3
"""Pin down the float32 flash_attn test's rare mismatch on the card.

    python3 scripts/flash_attn_f32_repro.py [--runs 30] [--fresh 40]
        [--ops 60] [--sanitize] [--out build/flash_attn_f32_repro]

``tests/test_torch_gpu.py::test_flash_attn_kernel_matches_plain[16-float32
-True]`` once failed on an H100 as the first test of a fresh process (60
of 19,200 values up to 4.1e-5 off, at its first shape (B, S, Hq, Hkv) =
(2, 100, 6, 2), hd 16, causal).  This script, from the repository root:

1. runs that test ``--runs`` times, each as the only test of a fresh
   ``pytest`` process, and counts the failures (the output of each
   failure goes to ``<out>/flash_attn_f32_fail_<i>.txt``);
2. runs ``--once`` in ``--fresh`` fresh processes: the kernel's first
   and second launch on the test's first draw, the plain version on the
   CPU and attention in float64 on the CPU, with a digest of each output
   and its distance to float64; then how many distinct digests each side
   gave over the processes, to tell which side moves;
3. runs ``--op-probe`` in ``--ops`` fresh processes: the CPU plain
   version's first call with every torch function evaluated twice in a
   row, and the functions whose two evaluations differ;
4. with ``--sanitize``, runs ``--once`` under ``compute-sanitizer`` with
   ``--tool racecheck``, ``initcheck`` and ``synccheck`` (from the CUDA
   toolkit) and prints each tool's exit code and summary (the whole
   report goes to ``<out>/sanitizer_<tool>.txt``).

It prints the card's name and power limit first and needs a CUDA device.
"""
import argparse
import hashlib
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
TEST = ("tests/test_torch_gpu.py::"
        "test_flash_attn_kernel_matches_plain[16-float32-True]")
SHAPE = (2, 100, 100, 6, 2)        # b, sq, skv, hq, hkv of the test
HD = 16
ENV = dict(os.environ, PYTHONPATH="src")


def draw():
    """q, k, v on the CPU: the test's first shape, drawn as it draws it."""
    import torch
    g = torch.Generator().manual_seed(HD)
    b, sq, skv, hq, hkv = SHAPE
    return (torch.randn(b, sq, hq, HD, generator=g),
            torch.randn(b, skv, hkv, HD, generator=g),
            torch.randn(b, skv, hkv, HD, generator=g))


def digest(t) -> str:
    return hashlib.sha1(t.numpy().tobytes()).hexdigest()[:10]


def attention_f64(q, k, v):
    """Causal GQA attention in float64, the plain softmax."""
    import torch
    q, k, v = (x.double() for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    k, v = (x.repeat_interleave(g, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    n_q, n_k = s.shape[-2:]
    keep = torch.arange(n_q)[:, None] >= torch.arange(n_k)[None]
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def once() -> int:
    import torch
    from repro_torch.kernels.flash_attn import (flash_attn_kernel,
                                                flash_attn_plain)
    q, k, v = draw()
    qc, kc, vc = (x.cuda() for x in (q, k, v))
    first = flash_attn_kernel(qc, kc, vc, causal=True).cpu()
    second = flash_attn_kernel(qc, kc, vc, causal=True).cpu()
    plain = flash_attn_plain(q, k, v, causal=True)
    want = attention_f64(q, k, v)
    err = lambda t: (t.double() - want).abs().max().item()
    past = int(((first - plain).abs() > 1e-5 + 1e-4 * plain.abs()).sum())
    print(f"once: first {digest(first)} second {digest(second)} plain "
          f"{digest(plain)}; max |diff| to float64: first {err(first):.3g}, "
          f"second {err(second):.3g}, plain {err(plain):.3g}; first vs "
          f"plain: {past} values past the bar", flush=True)
    return 0


def op_probe() -> int:
    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.kernels.flash_attn import flash_attn_plain
    torch.zeros(1, device="cuda")            # as in the test: CUDA is up
    differ = {}

    class Twice(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = getattr(func, "__name__", str(func))
            if (torch.is_tensor(out) and out.is_floating_point()
                    and not name.endswith("_") and "set" not in name
                    and not name.startswith("empty")):
                again = func(*args, **kwargs)
                if not torch.equal(out, again):
                    key = f"{name}{tuple(out.shape)}"
                    d = (out - again).abs().max().item()
                    differ[key] = max(differ.get(key, 0.0), d)
            return out

    q, k, v = draw()
    with Twice():
        first = flash_attn_plain(q, k, v, causal=True)
    print(f"probe: first {digest(first)}; functions whose two evaluations "
          f"differ: {differ or 'none'}", flush=True)
    return 0


def child(flag: str, i: int) -> str:
    run = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         cwd=REPO, env=ENV, capture_output=True, text=True,
                         timeout=600)
    line = next((ln for ln in run.stdout.splitlines()
                 if ln.startswith(("once:", "probe:"))),
                f"rc {run.returncode}: {run.stderr[-300:]}")
    print(f"fresh {flag} {i}: {line}", flush=True)
    return line


def fresh(flag: str, n: int, parts) -> None:
    lines = [child(flag, i) for i in range(n)]
    for part in parts:
        seen = {ln.split(f"{part} ")[1].split()[0].rstrip(";")
                for ln in lines if f"{part} " in ln}
        print(f"fresh {flag}: {len(seen)} distinct digests of {part} over "
              f"{n} processes", flush=True)


def pytest_runs(n: int, out: str) -> None:
    fails = 0
    for i in range(n):
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-m", "gpu", TEST], cwd=REPO, env=ENV, capture_output=True,
            text=True, timeout=600)
        if run.returncode != 0:
            fails += 1
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, f"flash_attn_f32_fail_{i}.txt"),
                      "w") as f:
                f.write(run.stdout + run.stderr)
        last = (run.stdout.strip().splitlines() or ["?"])[-1]
        print(f"fresh process {i}: rc {run.returncode} ({last})",
              flush=True)
    print(f"fresh processes: {fails} of {n} failed", flush=True)


def sanitize(out: str) -> None:
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "compute-sanitizer")
    for name in ("racecheck", "initcheck", "synccheck"):
        try:
            run = subprocess.run(
                [tool, "--tool", name, sys.executable,
                 os.path.abspath(__file__), "--once"], cwd=REPO, env=ENV,
                capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            print(f"compute-sanitizer --tool {name}: did not run ({e})",
                  flush=True)
            continue
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"sanitizer_{name}.txt"), "w") as f:
            f.write(run.stdout + run.stderr)
        lines = (run.stdout + run.stderr).strip().splitlines()
        summary = [ln for ln in lines if "SUMMARY" in ln or "Error:" in ln
                   or "once:" in ln][-6:]
        print(f"compute-sanitizer --tool {name}: rc {run.returncode}; "
              + " | ".join(summary or lines[-4:]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--ops", type=int, default=0)
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--op-probe", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "flash_attn_f32_repro"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_attn_f32_repro: no CUDA device", file=sys.stderr)
        return 2
    if args.once:
        return once()
    if args.op_probe:
        return op_probe()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    pytest_runs(args.runs, args.out)
    fresh("--once", args.fresh, ("first", "second", "plain"))
    fresh("--op-probe", args.ops, ("first",))
    if args.sanitize:
        sanitize(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
