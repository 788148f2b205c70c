"""DeepTileBars [Tang & Yang, AAAI'19] — CNNs over topical tile bars.
Port of ``repro.retrievers.deeptilebars``: the (Q, n_b) interaction image
(channels tf, idf_indicator, gauss_max) is scanned by Conv1Ds of widths
1-5 along the segment axis, max/mean-pooled and aggregated over terms."""
from __future__ import annotations

import torch

from ..models.layers import dense_init, mlp_apply, mlp_init
from .base import QMeta, RetrieverSpec, fidx, make_init, register

WIDTHS = (1, 2, 3, 4, 5)
N_FILT = 8
CHANNELS = ("tf", "idf_indicator", "gauss_max")


def _build(gen, n_b):
    convs = [{"w": dense_init(gen, w * len(CHANNELS), N_FILT),
              "b": torch.zeros(N_FILT)} for w in WIDTHS]
    d_feat = len(WIDTHS) * N_FILT * 2
    return {"convs": convs, "mlp": mlp_init(gen, (d_feat, 32, 1))}


init = make_init(_build)


def _conv1d(x: torch.Tensor, w: torch.Tensor, width: int) -> torch.Tensor:
    """x: (..., n_b, C); w: (width*C, F). Valid conv along n_b via patches."""
    n_b = x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, 0, max(0, width - 1)))
    patches = torch.stack([xp[..., i:i + n_b, :] for i in range(width)],
                          dim=-1)
    patches = patches.reshape(*x.shape[:-1], -1)       # (..., n_b, width*C)
    return patches @ w


def score(params, M, meta: QMeta, functions) -> torch.Tensor:
    img = torch.stack([M[..., fidx(functions, c)] for c in CHANNELS], dim=-1)
    # (B, Q, n_b, C); normalise the tf channel by segment length
    seg_norm = torch.clamp(meta.seg_len, min=1.0)[:, None, :, None]
    img = torch.cat([img[..., :1] / seg_norm, img[..., 1:]], dim=-1)
    seg_mask = (meta.seg_len > 0).to(torch.float32)[:, None, :, None]
    feats = []
    for w, cp in zip(WIDTHS, params["convs"]):
        h = torch.relu(_conv1d(img, cp["w"], w) + cp["b"])  # (B,Q,n_b,F)
        h = h * seg_mask
        feats.append(h.amax(dim=2))
        feats.append(h.sum(dim=2) / torch.clamp(seg_mask.sum(dim=2),
                                                min=1.0))
    f = torch.cat(feats, dim=-1)                        # (B, Q, feat)
    f = f * meta.q_mask[None, :, None]
    pooled = f.sum(dim=1) / torch.clamp(meta.q_mask.sum(), min=1.0)
    return mlp_apply(params["mlp"], pooled, act=torch.relu)[:, 0]


SPEC = register(RetrieverSpec(name="deeptilebars", init=init, score=score,
                              needs=CHANNELS))
