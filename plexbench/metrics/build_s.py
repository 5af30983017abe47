"""The host build: ``Snapshot.build``'s own wall time (``build_s``), the
shards over the configuration's build workers."""


def read(run):
    return run.build_s
