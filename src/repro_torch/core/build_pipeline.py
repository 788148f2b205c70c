"""Staged streaming index build — Algorithm 1 as a device-side pipeline
(port of ``repro.core.build_pipeline``, with its ``obs`` spans, counters
and gauges).

  stage 1  unique-term extraction   :func:`make_unique_terms_fn` — sort +
           first-occurrence compaction per doc, on the device.
  stage 2  interaction pass         ``builder.make_batch_interaction_fn``
           (``dot``/``cosine``/``gauss_max`` through the ``seg_interact``
           kernel), then :func:`make_compact_rows_fn`: the Algorithm-1
           ``tf > sigma`` mask and a stable sort by term on the device,
           so each batch leaves as one term-sorted posting run.
  stage 3  spill layer              :class:`RunSpiller` keeps the runs in
           host memory, or writes them to ``spill_dir`` so resident host
           bytes stay bounded by one run.
  stage 4  k-way run merge          ``core.index.build_shard_from_runs``
           (one CSR) or ``dist.partition.partitioned_from_runs`` (K
           term-range shards), on the host in numpy as in the reference.

Ids are exact: the tf filter compares integer-valued float32 sums, and
the merge lexsorts by (term, doc), so term ids, doc ids and run
boundaries equal the reference's bit for bit on the same corpus.

The ``build.*`` spans time the host, as the reference's do: stages 1
and 2 their launches, stage 2b the wait for the run length (the one
host sync of a batch, which the build had before), stage 3 the copies
and spill I/O.  The device time of each stage comes from the CUDA events
of ``BuildStats.stage_device_ms``, read once when the streaming ends.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..configs.base import SeineConfig
from ..kernels.utils import resolve_device
from .index import SegmentInvertedIndex, build_shard_from_runs
from .interactions import init_interaction_params, params_to
from .providers import EmbeddingProvider
from .vocab import Vocabulary

_log = obs.get_logger("repro.core.build")

STAGES = ("stage1_uniq", "stage2_interact", "stage2b_compact",
          "stage3_spill")


# ---------------------------------------------------------------------------
# stage 1: unique-term extraction on the device
# ---------------------------------------------------------------------------

def make_unique_terms_fn(max_uniq: int) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """(tokens (B, Lp) int32) -> (B, max_uniq) int32, -1 padded.

    Per doc: sort ascending (pads first), keep the first occurrence of
    each non-negative value, scatter it to its rank; ranks past
    ``max_uniq`` land in one extra slot that is sliced off (the
    reference's ``mode="drop"``).  Equals ``np.unique(tok[tok >=
    0])[:max_uniq]`` row by row."""
    def unique_terms(tokens: torch.Tensor) -> torch.Tensor:
        x = torch.sort(tokens, dim=1).values
        first = x >= 0
        first[:, 1:] &= x[:, 1:] != x[:, :-1]
        pos = torch.cumsum(first, dim=1) - 1
        slot = torch.where(first, pos, max_uniq).clamp(max=max_uniq)
        out = torch.full((x.shape[0], max_uniq + 1), -1, dtype=torch.int32,
                         device=x.device)
        out.scatter_(1, slot, x.to(torch.int32))
        return out[:, :max_uniq]

    return unique_terms


# ---------------------------------------------------------------------------
# stage 2b: filter + row compaction (one term-sorted run per batch)
# ---------------------------------------------------------------------------

def make_compact_rows_fn(vocab_size: int, sigma: float,
                         tf_index: Optional[int]):
    """(vals (B, U, n_b, n_f), uniq (B, U), doc_start) -> (term_ids (B*U,),
    doc_ids (B*U,), values (B*U, n_b, n_f), n_valid).

    The Algorithm-1 line-8 filter (``tf > sigma``; exact, tf sums are
    integer-valued float32) and the survivor compaction: rows are
    stable-sorted by term id (filtered rows keyed ``vocab_size`` sink to
    the tail).  The (B, U) flattening is doc-major, so doc ids stay
    ascending within each term and the first ``n_valid`` rows are a
    term-sorted run."""
    def compact(vals: torch.Tensor, uniq: torch.Tensor, doc_start: int):
        n_docs, n_u = uniq.shape
        mask = uniq >= 0
        if tf_index is not None:
            mask &= vals[..., tf_index].sum(-1) > sigma
        docs = (doc_start + torch.arange(n_docs, dtype=torch.int32,
                                         device=uniq.device))[:, None]
        docs = docs.expand(n_docs, n_u).reshape(-1)
        flat_mask = mask.reshape(-1)
        key = torch.where(flat_mask, uniq.reshape(-1).long(), vocab_size)
        order = torch.sort(key, stable=True).indices
        return (uniq.reshape(-1)[order], docs[order],
                vals.reshape((n_docs * n_u,) + vals.shape[2:])[order],
                flat_mask.sum())

    return compact


# ---------------------------------------------------------------------------
# stage 3: spill layer — term-sorted posting runs
# ---------------------------------------------------------------------------

@dataclass
class PostingRun:
    """One term-sorted run of posting triples (doc ascending within
    term), either resident (arrays held) or spilled (``path`` set,
    arrays None)."""
    n_rows: int
    nbytes: int
    term_ids: Optional[np.ndarray] = None   # (n,) int32, ascending
    doc_ids: Optional[np.ndarray] = None    # (n,) int32, asc within term
    values: Optional[np.ndarray] = None     # (n, n_b, n_f) float32
    path: Optional[str] = None

    @classmethod
    def from_arrays(cls, term_ids: np.ndarray, doc_ids: np.ndarray,
                    values: np.ndarray) -> "PostingRun":
        nbytes = term_ids.nbytes + doc_ids.nbytes + values.nbytes
        return cls(n_rows=int(term_ids.shape[0]), nbytes=nbytes,
                   term_ids=term_ids, doc_ids=doc_ids, values=values)

    def load(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.term_ids is not None:
            return self.term_ids, self.doc_ids, self.values
        with np.load(self.path) as z:
            return z["term_ids"], z["doc_ids"], z["values"]

    def ids(self) -> Tuple[np.ndarray, np.ndarray]:
        """(term_ids, doc_ids) without the values payload (a spilled
        run's npz members load lazily, so the values stay on disk)."""
        if self.term_ids is not None:
            return self.term_ids, self.doc_ids
        with np.load(self.path) as z:
            return z["term_ids"], z["doc_ids"]

    def term_counts(self, vocab_size: int) -> np.ndarray:
        """(|v|,) int64 postings per term in this run (a spilled run
        reads only its term ids)."""
        if self.term_ids is not None:
            t = self.term_ids
        else:
            with np.load(self.path) as z:
                t = z["term_ids"]
        return np.bincount(t, minlength=vocab_size)


class RunSpiller:
    """Accumulates per-batch posting runs, optionally spilling to disk.

    With ``spill_dir`` each run is written to ``run_<i>.npz`` and its host
    arrays dropped, so resident host bytes stay bounded by the largest
    single run instead of total nnz."""

    def __init__(self, spill_dir: Optional[str] = None):
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self.runs: List[PostingRun] = []
        self.run_bytes: List[int] = []      # per-batch run size
        self.resident_bytes = 0
        self.peak_host_bytes = 0
        self.spilled_bytes = 0

    def add(self, term_ids: np.ndarray, doc_ids: np.ndarray,
            values: np.ndarray) -> PostingRun:
        run = PostingRun.from_arrays(term_ids, doc_ids, values)
        self.run_bytes.append(run.nbytes)
        # the fresh run is resident while its fate is decided
        self.peak_host_bytes = max(self.peak_host_bytes,
                                   self.resident_bytes + run.nbytes)
        if self.spill_dir is not None:
            run.path = os.path.join(self.spill_dir,
                                    f"run_{len(self.runs):05d}.npz")
            np.savez(run.path, term_ids=term_ids, doc_ids=doc_ids,
                     values=values)
            run.term_ids = run.doc_ids = run.values = None
            self.spilled_bytes += run.nbytes
            obs.counter("seine_build_runs_spilled_total",
                        "posting runs written to spill_dir").inc()
            obs.counter("seine_build_spill_bytes_total",
                        "bytes spilled to disk").inc(run.nbytes)
        else:
            self.resident_bytes += run.nbytes
        self.runs.append(run)
        obs.counter("seine_build_runs_total",
                    "posting runs produced (resident or spilled)").inc()
        obs.gauge("seine_build_last_run_bytes",
                  "size of the newest per-batch run").set(run.nbytes)
        obs.gauge("seine_build_resident_bytes",
                  "run bytes currently resident on host").set(
            self.resident_bytes)
        obs.gauge("seine_build_peak_host_bytes",
                  "peak resident run bytes this build").set(
            self.peak_host_bytes)
        return run

    @property
    def total_nnz(self) -> int:
        return sum(r.n_rows for r in self.runs)

    @property
    def total_nnz_bytes(self) -> int:
        return sum(self.run_bytes)


# ---------------------------------------------------------------------------
# the staged pipeline
# ---------------------------------------------------------------------------

@dataclass
class BuildStats:
    """Telemetry of one streaming build.

    ``peak_host_bytes`` covers the streaming phase (stages 1-3): with a
    spill dir it is the largest single run.  ``stage_s`` holds host
    seconds per stage of :data:`STAGES` plus ``"stage4_merge"`` when a
    merge ran; work queued on the card is waited for where the host needs
    its result (the run length, in stage 2b), so device time of stages 1
    and 2 lands there.  ``stage_device_ms`` holds, on CUDA, the device
    time between the stage boundaries (CUDA events), which attributes it
    to the stage that queued it."""
    n_docs: int = 0
    n_batches: int = 0
    build_s: float = 0.0
    run_bytes: List[int] = field(default_factory=list)  # per batch
    peak_host_bytes: int = 0
    spilled_bytes: int = 0
    total_nnz: int = 0
    total_nnz_bytes: int = 0
    stage_s: Dict[str, float] = field(default_factory=dict)
    stage_device_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def docs_per_s(self) -> float:
        return self.n_docs / max(self.build_s, 1e-9)

    def summary(self) -> str:
        return (f"{self.n_docs} docs in {self.build_s:.2f}s "
                f"({self.docs_per_s:.0f} docs/s), {self.n_batches} runs, "
                f"peak host {self.peak_host_bytes/1e6:.1f} MB "
                f"(total postings {self.total_nnz_bytes/1e6:.1f} MB"
                f"{', spilled' if self.spilled_bytes else ''})")


def compute_doc_seg_lengths(tokens: np.ndarray, seg_ids: np.ndarray,
                            n_b: int) -> Tuple[np.ndarray, np.ndarray]:
    """(doc_len (n_docs,), seg_len (n_docs, n_b)) in one bincount pass
    over the flattened (doc, segment) grid (integer counts, so the
    float32 result is exact)."""
    n_docs = tokens.shape[0]
    valid = tokens >= 0
    flat = (np.arange(n_docs, dtype=np.int64)[:, None] * n_b
            + np.clip(seg_ids, 0, n_b - 1))
    seg_len = np.bincount(flat[valid].ravel(),
                          minlength=n_docs * n_b).reshape(n_docs, n_b)
    return valid.sum(1).astype(np.float32), seg_len.astype(np.float32)


class _StageClock:
    """Host seconds per stage, and on CUDA the device time between stage
    boundaries from CUDA events read once at the end."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = {s: 0.0 for s in STAGES}
        self._events: List[Tuple[str, Any, Any]] = []
        self._t = time.perf_counter()
        self._ev = self._event()

    def _event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def lap(self, stage: str) -> None:
        now = time.perf_counter()
        self.host[stage] += now - self._t
        self._t = now
        ev = self._event()
        if ev is not None:
            self._events.append((stage, self._ev, ev))
        self._ev = ev

    def device_ms(self) -> Dict[str, float]:
        if not self.cuda:
            return {}
        torch.cuda.synchronize()
        out = {s: 0.0 for s in STAGES}
        for stage, a, b in self._events:
            out[stage] += a.elapsed_time(b)
        return out


class BuildPipeline:
    """Stages 1-4 over an embedding provider and a vocabulary, on
    ``device`` (default CUDA; the provider's table and the interaction
    parameters are moved there).  ``ip`` defaults to
    ``init_interaction_params`` from a generator seeded with 17."""

    def __init__(self, cfg: SeineConfig, vocab: Vocabulary,
                 provider: EmbeddingProvider,
                 ip: Optional[Dict[str, Any]] = None,
                 functions: Optional[Sequence[str]] = None, device=None):
        self.cfg = cfg
        self.vocab = vocab
        self.provider = provider
        self.device = resolve_device(device)
        self.functions = tuple(functions or cfg.functions)
        self.ip = params_to(ip if ip is not None else
                            init_interaction_params(None,
                                                    provider.embed_dim),
                            self.device)
        self._idf = torch.from_numpy(
            np.asarray(vocab.idf, np.float32).copy()).to(self.device)

    # -- stages 1-3: tokens -> term-sorted runs -------------------------

    def stream_runs(self, tokens: np.ndarray, seg_ids: np.ndarray, *,
                    batch_size: int = 32, max_uniq: Optional[int] = None,
                    spill_dir: Optional[str] = None, verbose: bool = False,
                    doc_start: int = 0) -> Tuple[RunSpiller, BuildStats]:
        """Run stages 1-3 over all docs, one term-sorted posting run per
        batch into a :class:`RunSpiller`.  Row ``i`` of ``tokens`` lands
        as doc ``doc_start + i`` (a live index places new docs after the
        base corpus this way).  The last batch is padded to
        ``batch_size`` with pad tokens (-1) and pad segments (n_b - 1),
        so every batch has the same shapes."""
        from .builder import make_batch_interaction_fn

        n_docs, n_l = tokens.shape
        n_b = self.cfg.n_segments
        max_uniq = max_uniq or min(n_l, 512)
        uniq_fn = make_unique_terms_fn(max_uniq)
        interact_fn = make_batch_interaction_fn(
            self.provider, self._idf, self.ip, n_b, self.functions,
            device=self.device)
        tf_i = (self.functions.index("tf")
                if "tf" in self.functions else None)
        compact_fn = make_compact_rows_fn(
            self.vocab.size, float(self.cfg.sigma_index), tf_i)
        dev = self.device
        spiller = RunSpiller(spill_dir)
        t0 = time.perf_counter()
        clock = _StageClock(dev)
        with torch.inference_mode(), obs.span("build.stream_runs"):
            for s in range(0, n_docs, batch_size):
                e = min(s + batch_size, n_docs)
                pad = batch_size - (e - s)
                tb = np.pad(tokens[s:e], ((0, pad), (0, 0)),
                            constant_values=-1)
                sb = np.pad(seg_ids[s:e], ((0, pad), (0, 0)),
                            constant_values=n_b - 1)
                tb_d = torch.from_numpy(tb.astype(np.int32)).to(dev)
                sb_d = torch.from_numpy(sb.astype(np.int32)).to(dev)
                with obs.span("build.stage1.uniq"):
                    ub = uniq_fn(tb_d)                           # stage 1
                clock.lap("stage1_uniq")
                with obs.span("build.stage2.interact"):
                    vals = interact_fn(tb_d, sb_d, ub)           # stage 2
                clock.lap("stage2_interact")
                with obs.span("build.stage2b.compact"):
                    terms, docs, rows, n_valid = compact_fn(
                        vals, ub, doc_start + s)                 # stage 2b
                    n = int(n_valid)
                clock.lap("stage2b_compact")
                # padded docs hold only -1 slots, so they are masked out
                with obs.span("build.stage3.spill"):
                    spiller.add(terms[:n].cpu().numpy(),
                                docs[:n].cpu().numpy(),
                                rows[:n].cpu().numpy())          # stage 3
                clock.lap("stage3_spill")
                obs.counter("seine_build_docs_total",
                            "docs through build stages 1-3").inc(e - s)
                obs.counter("seine_build_batches_total",
                            "device batches streamed").inc()
                if verbose and (s // batch_size) % 16 == 0:
                    _log.info("streamed", docs=f"{e}/{n_docs}",
                              s=f"{time.perf_counter() - t0:.1f}",
                              resident_mb=(
                                  f"{spiller.resident_bytes / 1e6:.1f}"))
        stats = BuildStats(
            n_docs=n_docs, n_batches=len(spiller.runs),
            build_s=time.perf_counter() - t0,
            run_bytes=list(spiller.run_bytes),
            peak_host_bytes=spiller.peak_host_bytes,
            spilled_bytes=spiller.spilled_bytes,
            total_nnz=spiller.total_nnz,
            total_nnz_bytes=spiller.total_nnz_bytes,
            stage_s=dict(clock.host), stage_device_ms=clock.device_ms())
        obs.gauge("seine_build_docs_per_s",
                  "stage 1-3 streaming throughput").set(stats.docs_per_s)
        obs.gauge("seine_build_total_nnz",
                  "postings streamed in the last build").set(stats.total_nnz)
        return spiller, stats

    # -- stage 4 entries ---------------------------------------------------

    def build_index(self, tokens: np.ndarray, seg_ids: np.ndarray, *,
                    batch_size: int = 32, max_uniq: Optional[int] = None,
                    spill_dir: Optional[str] = None, verbose: bool = False
                    ) -> Tuple[SegmentInvertedIndex, BuildStats]:
        """Full-vocabulary merge (K = 1): one CSR on the device."""
        spiller, stats = self.stream_runs(
            tokens, seg_ids, batch_size=batch_size, max_uniq=max_uniq,
            spill_dir=spill_dir, verbose=verbose)
        doc_len, seg_len = compute_doc_seg_lengths(
            tokens, seg_ids, self.cfg.n_segments)
        t0 = time.perf_counter()
        with obs.span("build.stage4.merge"):
            obs.gauge("seine_merge_fan_in",
                      "runs k-way-merged in stage 4").set(len(spiller.runs))
            index = build_shard_from_runs(
                spiller.runs, 0, self.vocab.size, idf=self.vocab.idf,
                doc_len=doc_len, seg_len=seg_len, n_docs=tokens.shape[0],
                vocab_size=self.vocab.size, n_b=self.cfg.n_segments,
                functions=self.functions, device=self.device)
        stats.stage_s["stage4_merge"] = time.perf_counter() - t0
        return index, stats

    def build_partitioned(self, tokens: np.ndarray, seg_ids: np.ndarray,
                          k: int, *, batch_size: int = 32,
                          max_uniq: Optional[int] = None,
                          spill_dir: Optional[str] = None,
                          verbose: bool = False, mesh=None,
                          codec: str = "none",
                          codec_tile: Optional[int] = None):
        """Shard-native build: runs -> K term-range shards directly,
        packed at merge time under ``codec``.  Returns
        ``(PartitionedIndex, BuildStats)``.  With ``mesh`` every rank
        runs this same deterministic build and keeps its own shards
        (``dist.sharding.shard_partitioned_index``); a codec then
        raises ``ValueError``."""
        from ..dist.partition import partitioned_from_runs

        spiller, stats = self.stream_runs(
            tokens, seg_ids, batch_size=batch_size, max_uniq=max_uniq,
            spill_dir=spill_dir, verbose=verbose)
        doc_len, seg_len = compute_doc_seg_lengths(
            tokens, seg_ids, self.cfg.n_segments)
        t0 = time.perf_counter()
        with obs.span("build.stage4.merge"):
            obs.gauge("seine_merge_fan_in",
                      "runs k-way-merged in stage 4").set(len(spiller.runs))
            pidx = partitioned_from_runs(
                spiller.runs, k, idf=self.vocab.idf, doc_len=doc_len,
                seg_len=seg_len, n_docs=tokens.shape[0],
                vocab_size=self.vocab.size, n_b=self.cfg.n_segments,
                functions=self.functions, mesh=mesh, codec=codec,
                codec_tile=codec_tile, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        stats.stage_s["stage4_merge"] = time.perf_counter() - t0
        return pidx, stats
