"""The port's serve CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``), both run in process on the CPU (the
port's with ``--device cpu``) at the same flags and seed.

The retriever's weights and the HashProvider table are random and drawn
differently by the two packages, so scores and latencies differ; what
does not depend on them must be equal: the corpus and the index ids
(``nnz``, ``delta_nnz``, the live doc counts, generation, tombstones),
the served and rejected counts at a rate nothing sheds, and every metric
family, span name and label set in ``--metrics-out``.  The argument
errors are checked one by one against the reference's messages.
"""
import os
import subprocess
import sys

import pytest

from repro import obs as jax_obs
from repro.launch import serve as jax_serve
from repro_torch import obs
from repro_torch.obs import log as obs_log
from repro_torch.launch import serve
from torch_helpers import fresh_registry
import torch_threads  # noqa: F401  (PyTorch threads per test process)

LIVE = ["--partition", "term", "--live", "--live-compact", "--target-qps",
        "200", "--coalesce", "--n-queries", "16", "--candidates", "50"]


def _log_lines(err: str) -> dict:
    """``{message: {key: value}}`` of the serve logger's lines."""
    out = {}
    for line in err.splitlines():
        if not line.startswith("[repro.launch.serve] "):
            continue
        words = line[len("[repro.launch.serve] "):].split(" ")
        msg, fields, key = [], {}, None
        for w in words:
            if "=" in w and (key is not None or msg):
                key, _, v = w.partition("=")
                fields[key] = v
            elif key is None:
                msg.append(w)
            else:                     # a value with spaces (stats=...)
                fields[key] += " " + w
        out[" ".join(msg)] = fields
    return out


def _run(mod, registry, argv, monkeypatch, capsys):
    # families registered by test files run earlier in this process
    # would otherwise be written too
    fresh_registry(monkeypatch, registry)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    mod.main()
    return _log_lines(capsys.readouterr().err)


def _labels(path) -> dict:
    """``{family: {label set}}`` of a Prometheus snapshot."""
    fams = obs.parse_prometheus(path.read_text())
    return {name: set(samples) for name, samples in fams.items()}


def _both(argv, tmp_path, monkeypatch, capsys):
    jax_out, port_out = tmp_path / "jax.prom", tmp_path / "port.prom"
    want = _run(jax_serve, jax_obs, argv + ["--metrics-out", str(jax_out)],
                monkeypatch, capsys)
    got = _run(serve, obs, argv + ["--metrics-out", str(port_out),
                                   "--device", "cpu"], monkeypatch, capsys)
    return got, want, _labels(port_out), _labels(jax_out)


def _same(got, want, msg, keys):
    assert msg in got and msg in want, msg
    for k in keys:
        assert got[msg][k] == want[msg][k], (msg, k)


def test_live_compaction_run_matches_jax(tmp_path, monkeypatch, capsys):
    got, want, fams, jax_fams = _both(LIVE, tmp_path, monkeypatch, capsys)
    _same(got, want, "live index", ("base_docs", "held_back"))
    _same(got, want, "index built", ("nnz",))
    _same(got, want, "live ingest done", ("docs", "delta_nnz"))
    _same(got, want, "live compaction done", ("generation", "tombstones"))
    _same(got, want, "SEINE open-loop", ("served", "rejected", "goodput"))
    assert got["index built"]["nnz"] == "1631"
    assert got["live ingest done"]["delta_nnz"] == "1655"
    assert got["live compaction done"] == dict(generation="1",
                                               tombstones="4")
    assert got["SEINE open-loop"]["rejected"] == "0"
    assert fams == jax_fams
    types = [ln for ln in (tmp_path / "port.prom").read_text().splitlines()
             if ln.startswith("# TYPE")]
    assert len(types) == 44        # metric families, as the JAX CLI's
    spans = {dict(k)["span"] for k in fams["seine_span_count_total"]}
    assert spans == {"build.stream_runs", "build.stage1.uniq",
                     "build.stage2.interact", "build.stage2b.compact",
                     "build.stage3.spill", "build.stage4.merge",
                     "frontend.batch", "live.ingest", "live.compact"}


def test_retrieve_and_packed_runs_match_jax(tmp_path, monkeypatch, capsys):
    for argv, msg, keys in (
            (["--partition", "term", "--retrieve-k", "10", "--n-queries",
              "4"], "SEINE first-stage", ("requests", "k", "corpus")),
            (["--partition", "term", "--shards", "2", "--codec", "packed",
              "--n-queries", "4", "--candidates", "32"], "SEINE",
             ("requests", "candidates"))):
        got, want, fams, jax_fams = _both(argv, tmp_path, monkeypatch,
                                          capsys)
        _same(got, want, "index built", ("nnz",))
        _same(got, want, msg, keys)
        if "--codec" in argv:
            _same(got, want, "term-partitioned (shard-native build)",
                  ("shards", "codec", "total_mb"))
        assert fams == jax_fams, argv


# the reference's argument errors, each with the flags that provoke it
ERRORS = [
    ["--retrieve-k", "-1"],
    ["--codec", "packed"],
    ["--target-qps", "-1"],
    ["--target-qps", "10", "--retrieve-k", "5"],
    ["--target-qps", "10", "--slo-ms", "-1"],
    ["--target-qps", "10", "--cache-tiles", "-1"],
    ["--target-qps", "10", "--cache-tiles", "8"],
    ["--target-qps", "10", "--coalesce", "--cache-tiles", "8"],
    ["--coalesce"],
    ["--slo-ms", "5"],
    ["--max-batch", "4"],
    ["--batch-timeout-ms", "1"],
    ["--live"],
    ["--partition", "term", "--live", "--compare-noindex"],
    ["--partition", "term", "--live", "--live-hold-frac", "1.5"],
    ["--live-compact"],
    ["--live-hold-frac", "0.3"],
    ["--metrics-out", "/nonexistent-dir/x.prom"],
    ["--partition", "doc"],
    ["--data-parallel", "--retrieve-k", "5"],
    ["--data-parallel", "--partition", "term", "--codec", "packed"],
    ["--data-parallel", "--target-qps", "10"],
    ["--data-parallel", "--partition", "term", "--live"],
]


@pytest.mark.parametrize("argv", ERRORS, ids=lambda a: " ".join(a))
def test_argument_errors_match_jax(argv, monkeypatch, capsys):
    msgs = []
    for mod, extra in ((jax_serve, []), (serve, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv + extra)
        with pytest.raises(SystemExit) as exc:
            mod.main()
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[1]


def _scores(err: str) -> list:
    """The ``scores`` debug lines' values, request by request."""
    return [line.split(" values=")[1] for line in err.splitlines()
            if line.startswith("[repro.launch.serve] DEBUG: scores ")]


def test_data_parallel_and_no_card_refused(monkeypatch, capsys):
    """``--data-parallel`` serves: two gloo ranks under ``torchrun`` log
    the single-process CLI's scores (``REPRO_LOG=debug``), rank 0 alone
    logging, and so does a 1 x 1 mesh in process; without ``--device
    cpu`` and without a card the CLI fails."""
    argv = ["serve", "--n-queries", "3", "--candidates", "32", "--device",
            "cpu"]
    level = obs_log.level_name()
    obs.set_level("debug")
    try:
        got = []
        for extra in ([], ["--data-parallel"]):
            fresh_registry(monkeypatch, obs)
            monkeypatch.setattr(sys, "argv", argv + extra)
            serve.main()
            got.append(_scores(capsys.readouterr().err))
    finally:
        obs.set_level(level)
    assert len(got[0]) == 3 and got[1] == got[0]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", REPRO_LOG="debug",
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--data-parallel"] + argv[1:], cwd=repo, env=env,
        capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert _scores(run.stderr) == got[0]
    assert "data-parallel devices=2 mesh={'data': 2, 'model': 1}" in \
        run.stderr
    assert run.stderr.count("[repro.launch.serve] SEINE ") == 1
    # the CLI runs on the card by default and never carries on on the CPU
    monkeypatch.setattr(sys, "argv", ["serve", "--n-queries", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main()
