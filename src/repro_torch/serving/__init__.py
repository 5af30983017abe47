from .delta import DELTA_CAP_MIN, DeltaBuffer, next_pow2
from .plex_service import PlexService, ServiceStats

__all__ = ["DELTA_CAP_MIN", "DeltaBuffer", "PlexService", "ServiceStats",
           "next_pow2"]
