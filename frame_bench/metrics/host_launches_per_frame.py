"""Layer host dispatch: the host's calls that put work on the device
(kernel launches, copies, sets, graph launches) in the traced window,
from the profiler's trace, divided by the frames issued in it."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    return run.trace.launches / run.traced_frames
