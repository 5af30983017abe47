"""The share of the profiled span with no kernel, copy or memset running
on the card (``torch.profiler``)."""


def read(run):
    if run.span is None or run.span.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.span.busy_s / run.span.window_s)
