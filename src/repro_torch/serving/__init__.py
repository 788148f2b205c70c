from .engine import (SeineEngine, ServeStats, make_qmeta, serve_batches,
                     serve_retrieval)

__all__ = ["SeineEngine", "ServeStats", "make_qmeta", "serve_batches",
           "serve_retrieval"]
