"""The benchmark's frozen yardstick: the card's published peaks and the
kernel bounds. Each configuration's model-FLOP counter is its reference's
``flops`` (``reference/<name>.py``).

The peaks and bounds are copies of ``chip_smoke.py``'s (``PEAK``,
``SOFTMAX_OPS``, ``EXP_RATE``, ``attention_bound``, ``msa_block_bound``,
``gated_ffn_bound``, ``mlp_tail_bound``, ``exp_floor_ms``), kept here so
that a change to the program cannot move them. A bound counts each input
read once and each output written once, and the matrix products at the
tensor cores' bf16 rate.
"""

from __future__ import annotations

# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense rates): tensor cores bf16 and TF32, float32 outside them, HBM3
PEAK = dict(bf16=989e12, tf32=495e12, f32=67e12, hbm=3.35e12)
# exponentials a second on the special-function units of one H100 SXM
EXP_RATE = 3.9e12
# elementwise operations of the softmax per score: scale, bias, running
# maximum, subtraction, exponential, sum, division
SOFTMAX_OPS = 7


def _bound(mm: float, vec: float, byts: float):
    t_ops = max(mm / PEAK["bf16"], vec / PEAK["f32"])
    t_bytes = byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def attention_bound(bw: int, heads: int, nq: int, nk: int, d: int,
                    esize: int, mask_windows: int = 0, proj_dim: int = 0):
    """(bound_ms, bound_by) of attention with a dense float32 bias over bw
    windows: q, k, v, out and the bias each moved once over the HBM rate,
    against the two products at the tensor cores' bf16 rate and the
    softmax's elementwise work at the float32 rate. ``mask_windows``: the
    windows of a float32 shift mask, read once. ``proj_dim``: q and output
    projections counted in (0 for none)."""
    mm = 4 * bw * heads * nq * nk * d + 4 * bw * nq * proj_dim * proj_dim
    vec = SOFTMAX_OPS * bw * heads * nq * nk
    byts = (bw * heads * (2 * nq + 2 * nk) * d * esize
            + (heads + mask_windows) * nq * nk * 4
            + 2 * (proj_dim + 1) * proj_dim * esize)
    return _bound(mm, vec, byts)


def msa_block_bound(b: int, hw: int, ws: int, esize: int, mask_windows: int,
                    c: int = 180, heads: int = 6):
    """(bound_ms, bound_by) of one ``fused_msa_block(_shifted)`` call on
    (b, hw, hw, c) activations at window ws: x read and out written once,
    the weights, the float32 RPB and ``mask_windows`` windows of mask, over
    the HBM rate, against the two projections and the attention's two
    products at the tensor cores' bf16 rate."""
    tok = b * hw * hw
    n = ws * ws
    mm = (2 * tok * c * 3 * c + 2 * tok * c * c
          + 4 * (tok // n) * heads * n * n * (c // heads))
    byts = (2 * tok * c * esize + (4 * c * c + 4 * c) * esize
            + (heads + mask_windows) * n * n * 4)
    return _bound(mm, 0.0, byts)


def gated_ffn_bound(tok: int, c: int, m: int, c_out: int, esize: int,
                    block: bool):
    """(bound_ms, bound_by) of one gated FFN call on tok pixels, C c, M m,
    C_out c_out: x read and out written once with the weights (the block's
    LayerNorm parameters too), over the HBM rate, against fc1 and fc2 at
    the tensor cores' bf16 rate and the depthwise 3 x 3 at the float32
    rate."""
    mm = 2 * tok * c * 2 * m + 2 * tok * m * c_out
    vec = 2 * 9 * tok * 2 * m
    byts = (tok * (c + c_out) + 2 * c * m + m * c_out + 22 * m + c_out
            + (2 * c if block else 0)) * esize
    return _bound(mm, vec, byts)


def mlp_tail_bound(sum3: bool, tok: int, c: int, hid: int, esize: int):
    """(bound_ms, bound_by) of one ``mlp_block`` (``sum3``: its three-input
    forms) call on tok pixels of width c at hidden width hid."""
    inputs = 3 if sum3 else 1
    byts = ((inputs + 1) * tok * c + 2 * c * hid + hid + 3 * c) * esize
    return _bound(4 * tok * c * hid, 0.0, byts)


def exp_floor_ms(bw: int, heads: int, nq: int, nk: int) -> float:
    """Least time for the softmax's exponentials on the special-function
    units; stated beside a bound, not in it."""
    return bw * heads * nq * nk / EXP_RATE * 1e3
