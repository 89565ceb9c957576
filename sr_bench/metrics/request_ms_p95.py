"""request_ms_p95: the 95th percentile, over every request of the window,
of the time from the send to the return of ``Predictor.predict_array``, by
the host clock (``statistics.quantiles``, exclusive method)."""

import statistics


def read(r):
    ms = [req.latency_s * 1e3 for req in r.requests]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=100)[94]
