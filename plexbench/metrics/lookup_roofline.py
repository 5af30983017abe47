"""The lookups' share of their roofline over the profiled span: the least
time the lookups answered in the span could take (``roofline.lookup_bytes``
of their requests, sectors counted request by request, over the card's
peak memory bandwidth) over the device time of every kernel the span ran.
Nothing to read without a trace, a kernel or the card's peak."""
from plexbench import roofline


def read(run):
    span = run.span
    if span is None or span.kernel_s <= 0:
        return None
    bw = roofline.peak(run.kind, "hbm_bytes_per_s")
    if bw is None:
        return None
    r = run.requests
    done = r[r["ok"] & (r["t2"] >= span.h0) & (r["t2"] <= span.h1)]
    if not done.size:
        return None
    nbytes = roofline.lookup_bytes(
        run.keys, (run.load.queries(int(o), int(n))
                   for o, n in zip(done["offset"], done["size"])),
        run.device)
    return 100.0 * nbytes / bw / span.kernel_s
