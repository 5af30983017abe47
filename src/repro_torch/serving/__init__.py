from .delta import DELTA_CAP_MIN, DeltaBuffer, next_pow2
from .engine import ServeEngine
from .kv_cache import PagedKVStore, PageTable
from .plex_service import LookupTicket, PlexService, ServiceStats

__all__ = ["DELTA_CAP_MIN", "DeltaBuffer", "LookupTicket", "PagedKVStore",
           "PageTable", "PlexService", "ServeEngine", "ServiceStats",
           "next_pow2"]
