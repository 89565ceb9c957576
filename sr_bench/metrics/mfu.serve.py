"""mfu.serve: the whole forward's share of the card's bf16 peak, read as
``mfu.upscale`` reads it, in the cells that report ``request_ms_p95``."""

from sr_bench.spec import reader

read = reader("mfu.upscale")
