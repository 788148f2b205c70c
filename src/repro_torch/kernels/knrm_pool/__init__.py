from .kernel import knrm_pool_kernel
from .ops import knrm_pool
from .ref import MUS, SIGMAS, kernel_features, knrm_pool_ref

__all__ = ["MUS", "SIGMAS", "kernel_features", "knrm_pool",
           "knrm_pool_kernel", "knrm_pool_ref"]
