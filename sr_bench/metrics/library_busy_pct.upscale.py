"""cuDNN, cuBLAS and plain torch: the share of the device's compute time in
the traced window (memory copies and sets left out of both) of the ops
that are none of the program's own kernels (``trace.PORT_KERNELS``)."""

from sr_bench.trace import is_port_kernel


def _copy(name):
    low = name.lower()
    return "memcpy" in low or "memset" in low


def read(r):
    if r.timeline is None:
        return None
    total = r.timeline.device_s(lambda n: not _copy(n))
    if total <= 0:
        return None
    lib = r.timeline.device_s(lambda n: not _copy(n) and not is_port_kernel(n))
    return 100.0 * lib / total
