from .kernel import (csr_lookup_kernel, csr_lookup_packed_kernel,
                     csr_lookup_packed_plain, csr_lookup_plain,
                     retrieve_windows_kernel, retrieve_windows_packed_kernel)
from .ops import (csr_lookup, csr_retrieve_block, csr_retrieve_topk)
from .ref import (csr_lookup_packed_ref, csr_lookup_ref, lane_scales,
                  lookup_pairs_packed_ref, lookup_pairs_ref, merge_windows,
                  packed_bisect, retrieve_block_packed_ref,
                  retrieve_block_ref, retrieve_lanes, route_pairs,
                  route_terms, scan_block_packed_ref, scan_block_ref)

__all__ = ["csr_lookup", "csr_lookup_kernel", "csr_lookup_packed_kernel",
           "csr_lookup_packed_plain", "csr_lookup_packed_ref",
           "csr_lookup_plain", "csr_lookup_ref", "csr_retrieve_block",
           "csr_retrieve_topk", "lane_scales", "lookup_pairs_packed_ref",
           "lookup_pairs_ref", "merge_windows", "packed_bisect",
           "retrieve_block_packed_ref", "retrieve_block_ref",
           "retrieve_lanes", "retrieve_windows_kernel",
           "retrieve_windows_packed_kernel", "route_pairs", "route_terms",
           "scan_block_packed_ref", "scan_block_ref"]
