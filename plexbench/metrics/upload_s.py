"""Planes and upload: the service's construction, synchronised, less the
host build it contains."""


def read(run):
    if run.build_s is None:
        return None
    return run.ctor_s - run.build_s
