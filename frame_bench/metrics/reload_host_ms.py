"""Layer livelink: host time of the ticks that loaded a pushed world
(``FrameStats.reloads`` grew), mean over the untraced part of a
``--trace 1`` window, in ms."""


def read(run):
    if not run.trace_on or not run.reload_s:
        return None
    return 1e3 * sum(run.reload_s) / len(run.reload_s)
