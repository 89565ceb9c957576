"""device_idle_pct.serve: the device's idle share of the traced window,
read as ``device_idle_pct.upscale`` reads it, in the cells that report
``request_ms_p95``."""

from sr_bench.spec import reader

read = reader("device_idle_pct.upscale")
