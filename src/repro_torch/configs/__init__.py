from .base import SeineConfig
from .seine_letor import SEINE_LETOR, seine_smoke

__all__ = ["SEINE_LETOR", "SeineConfig", "seine_smoke"]
