"""Layer frame passes: host time of one ``passes/frame.py::render_frame``
call (dispatch of the whole frame), the harness's clock around each call
of the untraced part of a ``--trace 1`` window, mean, in ms."""


def read(run):
    if not run.render_s:
        return None
    return 1e3 * sum(run.render_s) / len(run.render_s)
