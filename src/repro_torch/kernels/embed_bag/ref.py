"""Oracle for embed_bag: ``models.embedding_bag.embedding_bag`` in sum
mode (port of ``repro.kernels.embed_bag.ref``)."""
from __future__ import annotations

from ...models.embedding_bag import embedding_bag


def embed_bag_ref(table, indices, offsets, n_bags=None):
    return embedding_bag(table, indices, offsets, mode="sum", n_bags=n_bags)
