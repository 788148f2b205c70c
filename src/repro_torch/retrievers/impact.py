"""Impact-style retrievers over SEINE's contextual atomic functions.
Port of ``repro.retrievers.impact``: ``tilde`` (deep query likelihood),
``epic`` (max-op contextual term impact weighted by idf) and
``deepimpact`` (learned term impacts summed over matched terms)."""
from __future__ import annotations

import torch

from .base import QMeta, RetrieverSpec, fidx, make_init, register

# --- TILDE: deep query likelihood --------------------------------------------

tilde_init = make_init(lambda gen, n_b: {})


def tilde_score(params, M, meta: QMeta, functions) -> torch.Tensor:
    logp = M[..., fidx(functions, "log_cond_prob")]     # (B, Q, n_b)
    present = M[..., fidx(functions, "tf")] > 0
    # best-matching segment's query likelihood; absent terms take a fixed
    # OOV penalty (smoothed QL)
    seg_ok = (meta.seg_len > 0)[:, None, :]
    best = torch.where(present & seg_ok, logp, -12.0).amax(dim=-1)  # (B, Q)
    return torch.sum(best * meta.q_mask[None, :], dim=1)


register(RetrieverSpec(name="tilde", init=tilde_init, score=tilde_score,
                       needs=("log_cond_prob", "tf")))

# --- EPIC: contextual impact via the max-op function -------------------------

epic_init = make_init(lambda gen, n_b: {"w": torch.ones(()),
                                        "b": torch.zeros(())})


def epic_score(params, M, meta: QMeta, functions) -> torch.Tensor:
    imp = M[..., fidx(functions, "max_op")]             # (B, Q, n_b)
    present = M[..., fidx(functions, "tf")].sum(-1) > 0  # (B, Q)
    doc_imp = torch.relu(params["w"] * imp + params["b"]).amax(dim=-1)
    s = doc_imp * meta.q_idf[None, :] * present
    return torch.sum(s * meta.q_mask[None, :], dim=1)


register(RetrieverSpec(name="epic", init=epic_init, score=epic_score,
                       needs=("max_op", "tf")))

# --- DeepImpact: learned MLP term impacts ------------------------------------

deepimpact_init = make_init(lambda gen, n_b: {"scale": torch.ones(()),
                                              "bias": torch.zeros(())})


def deepimpact_score(params, M, meta: QMeta, functions) -> torch.Tensor:
    imp = M[..., fidx(functions, "mlp_emb")]            # (B, Q, n_b)
    present = M[..., fidx(functions, "tf")] > 0
    term_imp = torch.relu(torch.where(present, imp, 0.0)).sum(dim=-1)
    s = params["scale"] * term_imp + params["bias"] * (term_imp > 0)
    return torch.sum(s * meta.q_mask[None, :], dim=1)


register(RetrieverSpec(name="deepimpact", init=deepimpact_init,
                       score=deepimpact_score, needs=("mlp_emb", "tf")))
