from .paged import PagePool, SequencePages
from .tiering import TieredKvCache

__all__ = ["PagePool", "SequencePages", "TieredKvCache"]
