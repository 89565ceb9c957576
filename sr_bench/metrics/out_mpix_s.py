"""out_mpix_s: output megapixels of every request of the window over the
window's length, by the host clock."""


def read(r):
    px = sum(req.out.shape[0] * req.out.shape[1] for req in r.requests)
    return px / r.window_s / 1e6
