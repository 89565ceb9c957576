"""Row 7's share of its roofline: the sum of ``gated_ffn_bound`` over its
launches (one a HAB a forward, at the forward's shape) over the device time
of ``mma_gated_dconv_ffn_kernel`` in the traced window. Nothing where the
kernel did not run as often as the forwards call for."""

from sr_bench.yardstick import gated_ffn_bound

KERNEL = "mma_gated_dconv_ffn_kernel"


def read(r):
    if r.timeline is None:
        return None
    net = r.net
    c = net["embed_dim"]
    m = int(c * net["mlp_ratio"])
    habs = sum(net["depths"])
    has = lambda name: KERNEL in name  # noqa: E731
    if r.timeline.launches(has) != habs * len(r.forwards):
        return None
    bound_ms = sum(habs * gated_ffn_bound(b * h * w, c, m, c, 2, True)[0]
                   for b, h, w in r.forwards)
    return 100.0 * bound_ms * 1e-3 / r.timeline.device_s(has)
