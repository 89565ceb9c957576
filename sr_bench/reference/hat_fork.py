"""Plain float32 HAT of the ESC-infused fork (``type: HAT``) in eval mode,
on a parameter dict under the fork's checkpoint names, for an NHWC input
whose sides are window multiples.

The HAB: LayerNorm, then x + ESC conv attention + conv_scale * CAB with an
ECA gate, then x + the gated depthwise-conv FFN of the second LayerNorm.
ESC's conv attention (arXiv:2503.06671) runs on the first ``esc_pdim``
channels: a static 13 x 13 conv plus a per-sample dynamic 3 x 3 depthwise
conv whose kernels come from the slab's pixel mean (1 x 1, GELU, 1 x 1),
then a 1 x 1 conv over [attended slab, the other channels]. The OCAB is
HAT's, with separate q and kv projections; its ESC-infused form
(``ocab_esc_enable``) is not part of this reference.

Departures from the fork's code: the 1 x 1 convs on pooled vectors and
on the slab concat as matrix products; the per-sample dynamic conv as one
grouped conv over the batch; no drop path (eval mode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sr_bench.reference.common import (Precision, conv, conv_flops, dense,
                                       gather_bias, layer_norm, linear, mlp,
                                       mlp_flops, norm, ocab_attention,
                                       ocab_attention_flops, ocab_table,
                                       rpi_oca, shell_flops, shell_forward,
                                       shell_shapes)


def eca_cab(p: Precision, params: dict, pre: str, x):
    """conv 3 x 3 -> GELU -> conv 3 x 3 -> ECA (a 5-tap conv over the
    channels of the pixel mean, sigmoid gate)."""
    y = x.permute(0, 3, 1, 2)
    y = F.gelu(conv(p, y, params[pre + "cab.0.weight"],
                    params[pre + "cab.0.bias"]))
    y = conv(p, y, params[pre + "cab.2.weight"], params[pre + "cab.2.bias"])
    g = y.mean(dim=(2, 3))[:, None, :]                        # (B, 1, C)
    w = params[pre + "cab.3.conv.weight"]
    g = F.conv1d(p.q(g), p.q(w), None, 1, w.shape[-1] // 2)
    return (y * torch.sigmoid(g[:, 0])[:, :, None, None]).permute(0, 2, 3, 1)


def esc_attention(p: Precision, params: dict, pre: str, x, lk_filter):
    """ESC conv attention of an NHWC x (the HAB's normed input)."""
    b, h, w, c = x.shape
    pdim = lk_filter.shape[0]
    x1 = x[..., :pdim].permute(0, 3, 1, 2)                    # (B, pdim, H, W)
    g = x1.mean(dim=(2, 3))
    dk = F.gelu(linear(p, g, params[pre + "plk.dwc_proj.1.weight"].flatten(1),
                       params[pre + "plk.dwc_proj.1.bias"]))
    dk = linear(p, dk, params[pre + "plk.dwc_proj.3.weight"].flatten(1),
                params[pre + "plk.dwc_proj.3.bias"])         # (B, pdim * 9)
    dyn = conv(p, x1.reshape(1, b * pdim, h, w),
               dk.reshape(b * pdim, 1, 3, 3), groups=b * pdim)
    att = conv(p, x1, lk_filter) + dyn.reshape(b, pdim, h, w)
    cat = torch.cat([att.permute(0, 2, 3, 1), x[..., pdim:]], dim=-1)
    return linear(p, cat, params[pre + "aggr.weight"].flatten(1),
                  params[pre + "aggr.bias"])


def gated_ffn(p: Precision, params: dict, pre: str, x):
    """fc1 -> depthwise 3 x 3 -> d[:M] * silu(d[M:]) -> fc2."""
    hid = linear(p, x, params[pre + "fc1.weight"], params[pre + "fc1.bias"])
    m2 = hid.shape[-1]
    d = conv(p, hid.permute(0, 3, 1, 2), params[pre + "dw.weight"],
             params[pre + "dw.bias"], groups=m2).permute(0, 2, 3, 1)
    g = d[..., :m2 // 2] * F.silu(d[..., m2 // 2:])
    return linear(p, g, params[pre + "fc2.weight"], params[pre + "fc2.bias"])


def hab(p: Precision, params: dict, pre: str, net: dict, x):
    ln1 = layer_norm(x, params, pre + "norm1")
    conv_x = eca_cab(p, params, pre + "conv_block.", ln1)
    attn_x = esc_attention(p, params, pre + "esc_attn.core.", ln1,
                           params[pre + "esc_attn.plk_filter"])
    x = x + attn_x + net["conv_scale"] * conv_x
    return x + gated_ffn(p, params, pre + "mlp.",
                         layer_norm(x, params, pre + "norm2"))


def ocab(p: Precision, params: dict, pre: str, net: dict, x):
    ws, heads = net["window_size"], net["num_heads"][0]
    xn = layer_norm(x, params, pre + "norm1")
    q = linear(p, xn, params[pre + "q_proj.weight"], params[pre + "q_proj.bias"])
    kv = linear(p, xn, params[pre + "kv_proj.weight"],
                params[pre + "kv_proj.bias"])
    bias = gather_bias(params[pre + "relative_position_bias_table"],
                       rpi_oca(ws, net["overlap_ratio"]))
    out = ocab_attention(p, q, kv, bias, heads, ws, net["overlap_ratio"])
    x = linear(p, out, params[pre + "proj.weight"],
               params[pre + "proj.bias"]) + x
    return x + mlp(p, layer_norm(x, params, pre + "norm2"), params,
                   pre + "mlp.0", pre + "mlp.2")


def forward(params: dict, net: dict, x, p: Precision | None = None):
    """The fork's HAT on an NHWC float32 input (window-multiple sides)."""
    if net.get("ocab_esc_enable"):
        raise NotImplementedError("the ESC-infused OCAB is not in this "
                                  "reference")
    p = p or Precision()

    def group(i, y):
        pre = f"layers.{i}.residual_group."
        for j in range(net["depths"][i]):
            y = hab(p, params, f"{pre}blocks.{j}.", net, y)
        return ocab(p, params, pre + "overlap_attn.", net, y)
    return shell_forward(p, params, net, x, group)


def flops(net: dict, b: int, h: int, w: int) -> int:
    """Model FLOPs of one forward (ESC conv-attention HAB, gated
    depthwise-conv FFN, ECA, the plain OCAB) on a (b, h, w) input whose
    sides are window multiples."""
    if net.get("ocab_esc_enable"):
        raise NotImplementedError("the ESC-infused OCAB is not counted")
    c, pix = net["embed_dim"], b * h * w
    m = int(c * net["mlp_ratio"])
    mid = c // net["compress_ratio"]
    pdim, k = net.get("esc_pdim", 16), net.get("esc_kernel", 13)
    esc = (2 * b * pdim * (pdim // 2) + 2 * b * (pdim // 2) * 9 * pdim
           + conv_flops(pix, 3, 1, pdim) + conv_flops(pix, k, pdim, pdim)
           + 2 * pix * c * c)
    cab = (conv_flops(pix, 3, c, mid) + conv_flops(pix, 3, mid, c)
           + 2 * b * c * 5)
    ffn = 2 * pix * c * 2 * m + conv_flops(pix, 3, 1, 2 * m) + 2 * pix * m * c
    ocab = (2 * pix * c * c + 2 * pix * c * 2 * c
            + ocab_attention_flops(net, pix) + 2 * pix * c * c
            + mlp_flops(pix, c, m))
    return (sum(net["depths"]) * (esc + cab + ffn)
            + len(net["depths"]) * ocab + shell_flops(net, b, h, w))


def param_shapes(net: dict) -> dict:
    """name -> shape of every parameter, under the fork's names."""
    c = net["embed_dim"]
    m = int(c * net["mlp_ratio"])
    mid = c // net["compress_ratio"]
    pdim, k = net.get("esc_pdim", 16), net.get("esc_kernel", 13)
    shapes = shell_shapes(net)
    for i, depth in enumerate(net["depths"]):
        pre = f"layers.{i}.residual_group."
        for j in range(depth):
            b = f"{pre}blocks.{j}."
            e = b + "esc_attn."
            norm(shapes, b + "norm1", c)
            shapes[e + "plk_filter"] = (pdim, pdim, k, k)
            shapes[e + "core.plk.dwc_proj.1.weight"] = (pdim // 2, pdim, 1, 1)
            shapes[e + "core.plk.dwc_proj.1.bias"] = (pdim // 2,)
            shapes[e + "core.plk.dwc_proj.3.weight"] = (9 * pdim, pdim // 2,
                                                        1, 1)
            shapes[e + "core.plk.dwc_proj.3.bias"] = (9 * pdim,)
            shapes[e + "core.aggr.weight"] = (c, c, 1, 1)
            shapes[e + "core.aggr.bias"] = (c,)
            shapes[b + "conv_block.cab.0.weight"] = (mid, c, 3, 3)
            shapes[b + "conv_block.cab.0.bias"] = (mid,)
            shapes[b + "conv_block.cab.2.weight"] = (c, mid, 3, 3)
            shapes[b + "conv_block.cab.2.bias"] = (c,)
            shapes[b + "conv_block.cab.3.conv.weight"] = (1, 1, 5)
            norm(shapes, b + "norm2", c)
            dense(shapes, b + "mlp.fc1", 2 * m, c)
            shapes[b + "mlp.dw.weight"] = (2 * m, 1, 3, 3)
            shapes[b + "mlp.dw.bias"] = (2 * m,)
            dense(shapes, b + "mlp.fc2", c, m)
        o = pre + "overlap_attn."
        norm(shapes, o + "norm1", c)
        dense(shapes, o + "q_proj", c, c)
        dense(shapes, o + "kv_proj", 2 * c, c)
        shapes[o + "relative_position_bias_table"] = ocab_table(net)
        dense(shapes, o + "proj", c, c)
        norm(shapes, o + "norm2", c)
        dense(shapes, o + "mlp.0", m, c)
        dense(shapes, o + "mlp.2", c, m)
    return shapes
