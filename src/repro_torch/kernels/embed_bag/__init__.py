from .kernel import embed_bag_kernel, embed_bag_plain
from .ops import bag_ptr_from_offsets, embed_bag, segment_bag_sums
from .ref import embed_bag_ref

__all__ = ["bag_ptr_from_offsets", "embed_bag", "embed_bag_kernel",
           "embed_bag_plain", "embed_bag_ref", "segment_bag_sums"]
