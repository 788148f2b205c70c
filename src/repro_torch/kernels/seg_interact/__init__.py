from .kernel import SEG_CHUNK, seg_interact_kernel, seg_interact_plain
from .ops import flatten_segments, seg_interact
from .ref import seg_interact_ref

__all__ = ["SEG_CHUNK", "flatten_segments", "seg_interact",
           "seg_interact_kernel", "seg_interact_plain", "seg_interact_ref"]
