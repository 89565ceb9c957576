"""Plain float32 HATClassic (the structure of the official ``HAT_SRx4.pth``):
the forward of XPixelGroup/HAT ``hat_arch.py`` in eval mode, on a parameter
dict under the official names, for an NHWC input whose sides are window
multiples.

Departures from the official code: NHWC tokens in place of (B, L, C)
sequences (the same arithmetic); the channel attention's 1 x 1 convs on the
pooled vector as matrix products; no drop path (eval mode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sr_bench.reference.common import (Precision, attention, conv,
                                       conv_flops, dense, gather_bias,
                                       heads_merge, heads_split, layer_norm,
                                       linear, mlp, mlp_flops, norm,
                                       ocab_attention, ocab_attention_flops,
                                       ocab_table, rpi_oca, rpi_sa,
                                       shell_flops, shell_forward,
                                       shell_shapes, shift_mask, unwindows,
                                       windows)


def cab(p: Precision, params: dict, pre: str, x):
    """conv 3 x 3 -> GELU -> conv 3 x 3 -> squeeze channel attention."""
    y = x.permute(0, 3, 1, 2)
    y = F.gelu(conv(p, y, params[pre + "cab.0.weight"],
                    params[pre + "cab.0.bias"]))
    y = conv(p, y, params[pre + "cab.2.weight"],
             params[pre + "cab.2.bias"]).permute(0, 2, 3, 1)
    g = y.mean(dim=(1, 2))
    g = F.relu(linear(p, g, params[pre + "cab.3.attention.1.weight"].flatten(1),
                      params[pre + "cab.3.attention.1.bias"]))
    g = torch.sigmoid(linear(
        p, g, params[pre + "cab.3.attention.3.weight"].flatten(1),
        params[pre + "cab.3.attention.3.bias"]))
    return y * g[:, None, None, :]


def hab(p: Precision, params: dict, pre: str, net: dict, x, shift: int):
    """(S)W-MSA + conv_scale * CAB residual, then the MLP residual."""
    b, h, w, c = x.shape
    ws, heads = net["window_size"], net["num_heads"][0]
    xn = layer_norm(x, params, pre + "norm1")
    conv_x = cab(p, params, pre + "conv_block.", xn)
    s = torch.roll(xn, (-shift, -shift), dims=(1, 2)) if shift else xn
    qkv = linear(p, windows(s, ws), params[pre + "attn.qkv.weight"],
                 params[pre + "attn.qkv.bias"])
    q, k, v = qkv.chunk(3, dim=-1)
    bias = gather_bias(params[pre + "attn.relative_position_bias_table"],
                       rpi_sa(ws))[None]
    if shift:
        mask = shift_mask(h, w, ws, shift, x.device)
        bias = (bias + mask[:, None]).repeat(b, 1, 1, 1)
    out = attention(p, heads_split(q, heads), heads_split(k, heads),
                    heads_split(v, heads), bias, (c // heads) ** -0.5)
    out = linear(p, heads_merge(out), params[pre + "attn.proj.weight"],
                 params[pre + "attn.proj.bias"])
    attn_x = unwindows(out, ws, b, h, w)
    if shift:
        attn_x = torch.roll(attn_x, (shift, shift), dims=(1, 2))
    x = x + attn_x + conv_x * net["conv_scale"]
    return x + mlp(p, layer_norm(x, params, pre + "norm2"), params,
                   pre + "mlp.fc1", pre + "mlp.fc2")


def ocab(p: Precision, params: dict, pre: str, net: dict, x):
    """Overlapping cross-attention (one qkv projection), then the MLP."""
    c = x.shape[-1]
    ws, heads = net["window_size"], net["num_heads"][0]
    xn = layer_norm(x, params, pre + "norm1")
    qkv = linear(p, xn, params[pre + "qkv.weight"], params[pre + "qkv.bias"])
    bias = gather_bias(params[pre + "relative_position_bias_table"],
                       rpi_oca(ws, net["overlap_ratio"]))
    out = ocab_attention(p, qkv[..., :c], qkv[..., c:], bias, heads, ws,
                         net["overlap_ratio"])
    x = linear(p, out, params[pre + "proj.weight"],
               params[pre + "proj.bias"]) + x
    return x + mlp(p, layer_norm(x, params, pre + "norm2"), params,
                   pre + "mlp.fc1", pre + "mlp.fc2")


def forward(params: dict, net: dict, x, p: Precision | None = None):
    """HATClassic on an NHWC float32 input (window-multiple sides)."""
    p = p or Precision()
    ws = net["window_size"]

    def group(i, y):
        pre = f"layers.{i}.residual_group."
        for j in range(net["depths"][i]):
            y = hab(p, params, f"{pre}blocks.{j}.", net, y,
                    0 if j % 2 == 0 else ws // 2)
        return ocab(p, params, pre + "overlap_attn.", net, y)
    return shell_forward(p, params, net, x, group)


def flops(net: dict, b: int, h: int, w: int) -> int:
    """Model FLOPs of one forward on a (b, h, w) input whose sides are
    window multiples."""
    c, pix = net["embed_dim"], b * h * w
    n = net["window_size"] ** 2
    hid = int(c * net["mlp_ratio"])
    mid, sq = c // net["compress_ratio"], c // net["squeeze_factor"]
    hab = (2 * pix * c * 3 * c + 4 * pix * n * c + 2 * pix * c * c
           + conv_flops(pix, 3, c, mid) + conv_flops(pix, 3, mid, c)
           + 4 * b * c * sq + mlp_flops(pix, c, hid))
    ocab = (2 * pix * c * 3 * c + ocab_attention_flops(net, pix)
            + 2 * pix * c * c + mlp_flops(pix, c, hid))
    return (sum(net["depths"]) * hab + len(net["depths"]) * ocab
            + shell_flops(net, b, h, w))


def param_shapes(net: dict) -> dict:
    """name -> shape of every parameter, under the official names."""
    c, ws, heads = net["embed_dim"], net["window_size"], net["num_heads"][0]
    hid = int(c * net["mlp_ratio"])
    mid, sq = c // net["compress_ratio"], c // net["squeeze_factor"]
    shapes = shell_shapes(net)
    for i, depth in enumerate(net["depths"]):
        pre = f"layers.{i}.residual_group."
        for j in range(depth):
            b = f"{pre}blocks.{j}."
            norm(shapes, b + "norm1", c)
            shapes[b + "attn.relative_position_bias_table"] = (
                (2 * ws - 1) ** 2, heads)
            dense(shapes, b + "attn.qkv", 3 * c, c)
            dense(shapes, b + "attn.proj", c, c)
            shapes[b + "conv_block.cab.0.weight"] = (mid, c, 3, 3)
            shapes[b + "conv_block.cab.0.bias"] = (mid,)
            shapes[b + "conv_block.cab.2.weight"] = (c, mid, 3, 3)
            shapes[b + "conv_block.cab.2.bias"] = (c,)
            shapes[b + "conv_block.cab.3.attention.1.weight"] = (sq, c, 1, 1)
            shapes[b + "conv_block.cab.3.attention.1.bias"] = (sq,)
            shapes[b + "conv_block.cab.3.attention.3.weight"] = (c, sq, 1, 1)
            shapes[b + "conv_block.cab.3.attention.3.bias"] = (c,)
            norm(shapes, b + "norm2", c)
            dense(shapes, b + "mlp.fc1", hid, c)
            dense(shapes, b + "mlp.fc2", c, hid)
        o = pre + "overlap_attn."
        norm(shapes, o + "norm1", c)
        dense(shapes, o + "qkv", 3 * c, c)
        shapes[o + "relative_position_bias_table"] = ocab_table(net)
        dense(shapes, o + "proj", c, c)
        norm(shapes, o + "norm2", c)
        dense(shapes, o + "mlp.fc1", hid, c)
        dense(shapes, o + "mlp.fc2", c, hid)
    return shapes
