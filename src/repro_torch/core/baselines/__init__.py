"""Baseline index structures the paper evaluates PLEX against (Figs. 2-3),
the port's copy of ``repro.core.baselines``.

All share the lookup contract of ``repro_torch.core.plex.PLEX.lookup``:
vectorised first-occurrence index of present keys (lower bound for absent
ones). They are host numpy over the port's own ``spline``, ``radix_table``,
``cht`` and ``plex.bounded_lower_bound``, as the reference's are host numpy:
comparison points for the index, with no device path.
ART is omitted — pointer-chasing adaptive nodes are CPU-specific and do not
transfer to the batched lookups of the card; BTree covers the classical
comparison point.
"""
from .bsearch import BinarySearch, build_binary_search
from .btree import BTree, build_btree
from .cht_index import CHTIndex, DuplicateKeysError, build_cht_index
from .pgm import PGMIndex, build_pgm
from .radixspline import RadixSpline, build_radixspline
from .rmi import RMI, build_rmi

__all__ = ["BTree", "BinarySearch", "CHTIndex", "DuplicateKeysError",
           "PGMIndex", "RMI", "RadixSpline", "build_binary_search",
           "build_btree", "build_cht_index", "build_pgm",
           "build_radixspline", "build_rmi"]
