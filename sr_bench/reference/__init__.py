"""Plain float32 references of the benchmark's configurations, one module
a network (``configs/<config>.json`` names it under ``reference``), each
with ``param_shapes``, ``forward`` and ``flops`` (its model-FLOP counter),
and the request path they share (``tile.py``). Nothing here imports the
program."""
