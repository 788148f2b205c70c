from .engine import (NoIndexEngine, SeineEngine, ServeStats, make_qmeta,
                     serve_batches, serve_retrieval)

__all__ = ["NoIndexEngine", "SeineEngine", "ServeStats", "make_qmeta",
           "serve_batches", "serve_retrieval"]
