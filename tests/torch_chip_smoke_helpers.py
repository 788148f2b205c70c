"""Shared plumbing of the CPU rehearsals of ``chip_smoke.py``
(``tests/test_torch_chip_smoke_*.py``): the script loaded as a module, the
launch counters wrapped around the kernels' names (the wrappers count
only on the card), and the host-clock stand-ins for the card-only timing
helpers.
"""
import os
import importlib.util
import time

import torch

from repro_torch.core import interactions
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.embed_bag import ops as eb_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.kernels.seg_interact import ops as seg_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counting(fn):
    def wrapper(*a, **k):
        fn.launches += 1
        return fn(*a, **k)
    return wrapper


def _counting_segments(fn, counter):
    """The segment entry counts on the CSR entry's counter."""
    def wrapper(*a, **k):
        counter.launches += 1
        return fn(*a, **k)
    return wrapper


def _host_ms(fns, iters):
    """One pass over ``fns`` on the host clock (``iters`` is for the
    card's timing loops)."""
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    return (time.perf_counter() - t0) * 1e3 / len(fns)


def _busy(run, n):
    """``device_busy``'s stand-in: the card's profile is not replayed."""
    return dict(ms=1.0, ops=1.0, host="", recorded=1, launched=1)


def _patch_build(cs, monkeypatch, tmp_path, **sizes):
    """Phase 5 at a hundred-odd docs, n_b 5, De 32, with the kernels'
    names wrapped in launch counters and card-only timing stubbed."""
    for name, value in dict(BUILD_DOCS=130, BUILD_N_B=5, BUILD_DE=32,
                            BUILD_MAX_LEN=160, BUILD_MAX_UNIQ=128,
                            N_CAND=60, N_REQUESTS=3, NOINDEX_REQUESTS=2,
                            INDEX_DIR=str(tmp_path / "idx"),
                            **sizes).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "events_ms", _host_ms)
    monkeypatch.setattr(cs, "device_ms",
                        lambda fns, iters, kernel, cold=False: None)
    monkeypatch.setattr(cs, "device_busy", _busy)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(lookup_ops, "_use_kernel",
                        lambda impl, like: impl in (None, "kernel"))
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (lookup_ops, "retrieve_windows_kernel"),
                      (knrm_ops, "knrm_pool_kernel"),
                      (interactions, "seg_interact_kernel"),
                      (seg_ops, "seg_interact_kernel"),
                      (eb_ops, "embed_bag_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))
    monkeypatch.setattr(eb_ops, "embed_bag_segment_kernel", _counting_segments(
        cs.embed_bag_segment_kernel, cs.embed_bag_kernel))


def _patch_lm(cs, monkeypatch, **sizes):
    """The LM phases at a few dozen docs of 160 tokens in batches of 16,
    the kernels' names wrapped in launch counters, card-only timing
    stubbed."""
    for name, value in dict(BUILD_DOCS=80, BUILD_N_B=5, BUILD_DE=32,
                            BUILD_MAX_LEN=160, BUILD_MAX_UNIQ=128,
                            LM_DOCS=48, LM_BATCH=16, LM_CAND=40,
                            LM_NOINDEX_CAND=16, **sizes).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "events_ms", _host_ms)
    monkeypatch.setattr(cs, "device_ms",
                        lambda fns, iters, kernel, cold=False: None)
    monkeypatch.setattr(cs, "kernel_split", lambda run, n: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(lookup_ops, "_use_kernel",
                        lambda impl, like: impl in (None, "kernel"))
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (lookup_ops, "retrieve_windows_kernel"),
                      (knrm_ops, "knrm_pool_kernel"),
                      (interactions, "seg_interact_kernel"),
                      (seg_ops, "seg_interact_kernel"),
                      (fa_ops, "flash_attn_kernel"),
                      (eb_ops, "embed_bag_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))
    monkeypatch.setattr(eb_ops, "embed_bag_segment_kernel", _counting_segments(
        cs.embed_bag_segment_kernel, cs.embed_bag_kernel))
