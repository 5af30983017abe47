"""K1's hot-key cache: hits over the lanes that went through the cache in
the window, from the service's own counters (``stats.cache_hits`` and
``stats.cache_queries``). Nothing to read where no lane went through a
cache (the per-shard path has none)."""


def read(run):
    lanes = run.stats1.get("cache_queries", 0) - \
        run.stats0.get("cache_queries", 0)
    if lanes <= 0 or run.stats1.get("epoch") != run.stats0.get("epoch"):
        return None
    hits = run.stats1["cache_hits"] - run.stats0["cache_hits"]
    return 100.0 * hits / lanes
