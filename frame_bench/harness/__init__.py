"""The frame benchmark's harness: one cell of ``BENCHMARK.json`` a run.

``spec`` finds a cell's configuration, traffic and metric files by name,
``traffic`` is the one generator every traffic file feeds, ``inputs``
builds both sides' inputs from a configuration file, ``loop`` drives the
timed window, ``trace`` reduces the profiler's trace, ``check`` holds the
window's frames against the plain reference (``frame_bench/reference``),
and ``cell`` ties them into one run.
"""
