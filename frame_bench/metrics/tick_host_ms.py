"""Layer engine: host time of one ``Engine.tick`` (livelink poll, world
load, view state, render, present), the harness's clock around each tick
of the untraced part of a ``--trace 1`` window, mean, in ms."""


def read(run):
    if not run.trace_on or not run.tick_s:
        return None
    return 1e3 * sum(run.tick_s) / len(run.tick_s)
