"""The share of its roofline of ``mma_msa_attention_kernel``, the attention
inside rows 1 and 2 (one launch a HAB a forward, a shifted one every second
HAB): the sum of ``attention_bound`` over the launches (bf16 q, k, v and
out, the float32 bias, and for a shifted HAB one float32 mask a window of
the image) over the kernel's device time in the traced window. Nothing
where it did not run as often as the forwards call for."""

from sr_bench.yardstick import attention_bound

KERNEL = "mma_msa_attention_kernel"


def read(r):
    if r.timeline is None:
        return None
    net = r.net
    ws, heads, c = net["window_size"], net["num_heads"][0], net["embed_dim"]
    n = ws * ws
    per = [(j % 2 == 1) for depth in net["depths"] for j in range(depth)]
    has = lambda name: KERNEL in name  # noqa: E731
    if r.timeline.launches(has) != len(per) * len(r.forwards):
        return None
    bound_ms = 0.0
    for b, h, w in r.forwards:
        nw = (h // ws) * (w // ws)
        for shifted in per:
            bound_ms += attention_bound(b * nw, heads, n, n, c // heads, 2,
                                        nw if shifted else 0)[0]
    return 100.0 * bound_ms * 1e-3 / r.timeline.device_s(has)
