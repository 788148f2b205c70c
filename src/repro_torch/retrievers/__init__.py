from . import bm25, deeptilebars, dot, hint, impact, knrm  # noqa: F401 (registry fill)
from .base import (QMeta, RetrieverSpec, all_retrievers, fidx, get_retriever,
                   hinge_pair_loss, register)

__all__ = ["QMeta", "RetrieverSpec", "all_retrievers", "fidx",
           "get_retriever", "hinge_pair_loss", "register"]
