"""The benchmark's plain reference (``render.py``): the frame the engine
should show, written from the engine's semantics in float64 PyTorch with
a brute-force rasterizer (``raster.py``), over inputs its own frozen
loaders read (``loaders/``). It imports nothing of the program, of the
JAX package or of JAX."""
