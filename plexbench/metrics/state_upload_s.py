"""Planes and upload as the program times them: the wall time of the
service constructor's ``_new_state`` (the host planes and their upload,
enqueued, not synchronised), which it keeps in ``stats.upload_s``. Nothing
to read from a program that keeps no such time."""


def read(run):
    value = run.stats0.get("upload_s")
    return float(value) if value else None
