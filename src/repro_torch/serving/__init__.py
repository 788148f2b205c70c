from .coalesce import CoalescingScorer, plan_coalesced
from .engine import (NoIndexEngine, SeineEngine, ServeStats, make_qmeta,
                     serve_batches, serve_retrieval)
from .frontend import (DeadlineExceeded, OpenLoopResult, ServeRequest,
                       ServingFrontend, run_open_loop)
from .tile_cache import PostingTileCache

__all__ = ["CoalescingScorer", "DeadlineExceeded", "NoIndexEngine",
           "OpenLoopResult", "PostingTileCache", "SeineEngine",
           "ServeRequest", "ServeStats", "ServingFrontend", "make_qmeta",
           "plan_coalesced", "run_open_loop", "serve_batches",
           "serve_retrieval"]
