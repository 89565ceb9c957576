"""Plain PyTorch pieces of the reference networks: float32, NCHW for the
convolutions and NHWC tokens for the transformer parts, after the official
HAT code (XPixelGroup/HAT ``hat_arch.py``), written for this benchmark and
importing nothing of the program.

Every matrix product and convolution takes its operands through
``Precision.q``: the identity for the reference, a rounding to float8 for
the control (:class:`Precision`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RGB_MEAN = (0.4488, 0.4371, 0.4040)
LN_EPS = 1e-5


class Precision:
    """How the reference rounds the operands of its products: ``float32``
    leaves them, ``fp8`` rounds each operand to float8 e4m3 with a scale of
    its own (amax / 448), the control one step below the bf16 the
    configurations serve in. Scores, softmax, norms and sums stay float32
    in both."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: float32 or fp8")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        amax = t.detach().abs().amax().clamp_min(1e-12)
        s = amax / 448.0
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(p: Precision, x, w, b=None):
    return F.linear(p.q(x), p.q(w), b)


def conv(p: Precision, x, w, b=None, padding: int | None = None,
         groups: int = 1):
    """NCHW conv with 'same' zero padding by default."""
    if padding is None:
        padding = w.shape[-1] // 2
    return F.conv2d(p.q(x), p.q(w), b, 1, padding, 1, groups)


def conv_nhwc(p: Precision, x, w, b=None):
    return conv(p, x.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)


def layer_norm(x, params: dict, name: str):
    return F.layer_norm(x, x.shape[-1:], params[name + ".weight"],
                        params[name + ".bias"], LN_EPS)


def rpi_sa(ws: int) -> torch.Tensor:
    """Swin's relative position index of a ws x ws window, (ws^2, ws^2)."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def rpi_oca(ws: int, overlap_ratio: float) -> torch.Tensor:
    """OCAB's index of a query window against its overlapping key window,
    (ws^2, ow^2)."""
    ow = ws + int(overlap_ratio * ws)
    ori = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                     indexing="ij")).flatten(1)
    ext = torch.stack(torch.meshgrid(torch.arange(ow), torch.arange(ow),
                                     indexing="ij")).flatten(1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0)
    rel = rel + (ws - ow + 1)
    return rel[..., 0] * (ws + ow - 1) + rel[..., 1]


def shift_mask(h: int, w: int, ws: int, shift: int,
               device) -> torch.Tensor:
    """(nW, ws^2, ws^2) additive mask, -100 between pixels of different
    regions of the shifted image."""
    img = torch.zeros((h, w), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = windows(img[None, :, :, None], ws)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def windows(x, ws: int):
    """(B, H, W, C) -> (B * nW, ws^2, C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def unwindows(x, ws: int, b: int, h: int, w: int):
    """Inverse of :func:`windows`."""
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def attention(p: Precision, q, k, v, bias, scale: float):
    """softmax(q k^T * scale + bias) v, (..., heads, N, d) operands, all in
    float32 but for the product operands' rounding."""
    s = torch.matmul(p.q(q * scale), p.q(k).transpose(-1, -2)) + bias
    return torch.matmul(p.q(torch.softmax(s, dim=-1)), p.q(v))


def heads_split(x, heads: int):
    """(Bw, N, C) -> (Bw, heads, N, d)."""
    bw, n, c = x.shape
    return x.reshape(bw, n, heads, c // heads).transpose(1, 2)


def heads_merge(x):
    bw, heads, n, d = x.shape
    return x.transpose(1, 2).reshape(bw, n, heads * d)


def ocab_attention(p: Precision, q_img, kv_img, bias, heads: int, ws: int,
                   overlap_ratio: float):
    """OCAB's attention: q in ws-windows, k and v in the zero-padded
    overlapping ow-windows that ``nn.Unfold`` cuts, as the official code
    does. q_img (B, H, W, C), kv_img (B, H, W, 2C)."""
    b, h, w, c = q_img.shape
    ow = ws + int(overlap_ratio * ws)
    qw = windows(q_img, ws)
    cols = F.unfold(kv_img.permute(0, 3, 1, 2), kernel_size=ow, stride=ws,
                    padding=(ow - ws) // 2)               # (B, 2C ow^2, L)
    kv = cols.reshape(b, 2, c, ow * ow, -1).permute(1, 0, 4, 3, 2)
    kv = kv.reshape(2, -1, ow * ow, c)
    out = attention(p, heads_split(qw, heads), heads_split(kv[0], heads),
                    heads_split(kv[1], heads), bias, (c // heads) ** -0.5)
    return unwindows(heads_merge(out), ws, b, h, w)


def gather_bias(table, index) -> torch.Tensor:
    """(heads, Nq, Nk) relative position bias from its table."""
    nq, nk = index.shape
    return table[index.reshape(-1).to(table.device)].reshape(
        nq, nk, -1).permute(2, 0, 1)


def mlp(p: Precision, x, params: dict, fc1: str, fc2: str):
    h = F.gelu(linear(p, x, params[fc1 + ".weight"], params[fc1 + ".bias"]))
    return linear(p, h, params[fc2 + ".weight"], params[fc2 + ".bias"])


def shell_forward(p: Precision, params: dict, net: dict, x, body_fn):
    """The HAT shell on an NHWC input whose sides are window multiples:
    mean shift, conv_first, patch norm, the residual groups (``body_fn(i,
    x)`` for group i), the final norm, conv_after_body and the global
    residual, then the pixel-shuffle reconstruction. Returns NHWC."""
    mean = torch.tensor(RGB_MEAN, device=x.device)
    img_range = net["img_range"]
    x = ((x - mean) * img_range).permute(0, 3, 1, 2)
    feat = conv(p, x, params["conv_first.weight"], params["conv_first.bias"])
    feat = feat.permute(0, 2, 3, 1)
    body = layer_norm(feat, params, "patch_embed.norm")
    for i in range(len(net["depths"])):
        y = body_fn(i, body)
        body = conv_nhwc(p, y, params[f"layers.{i}.conv.weight"],
                         params[f"layers.{i}.conv.bias"]) + body
    body = layer_norm(body, params, "norm")
    body = conv_nhwc(p, body, params["conv_after_body.weight"],
                     params["conv_after_body.bias"]) + feat
    y = body.permute(0, 3, 1, 2)
    y = F.leaky_relu(conv(p, y, params["conv_before_upsample.0.weight"],
                          params["conv_before_upsample.0.bias"]), 0.01)
    i = 0
    while f"upsample.{i}.weight" in params:
        y = F.pixel_shuffle(conv(p, y, params[f"upsample.{i}.weight"],
                                 params[f"upsample.{i}.bias"]), 2)
        i += 2
    y = conv(p, y, params["conv_last.weight"], params["conv_last.bias"])
    return (y.permute(0, 2, 3, 1) / img_range + mean)


def shell_shapes(net: dict) -> dict:
    """Parameter shapes of the HAT shell around the residual groups (each
    group's 3 x 3 conv included), under the checkpoints' names."""
    c, cin, feat = net["embed_dim"], net["in_chans"], 64
    shapes = {"conv_first.weight": (c, cin, 3, 3), "conv_first.bias": (c,),
              "patch_embed.norm.weight": (c,), "patch_embed.norm.bias": (c,)}
    for i in range(len(net["depths"])):
        shapes[f"layers.{i}.conv.weight"] = (c, c, 3, 3)
        shapes[f"layers.{i}.conv.bias"] = (c,)
    shapes.update({"norm.weight": (c,), "norm.bias": (c,),
                   "conv_after_body.weight": (c, c, 3, 3),
                   "conv_after_body.bias": (c,),
                   "conv_before_upsample.0.weight": (feat, c, 3, 3),
                   "conv_before_upsample.0.bias": (feat,)})
    scale, i = net["upscale"], 0
    while scale > 1:
        shapes[f"upsample.{i}.weight"] = (4 * feat, feat, 3, 3)
        shapes[f"upsample.{i}.bias"] = (4 * feat,)
        scale, i = scale // 2, i + 2
    shapes["conv_last.weight"] = (cin, feat, 3, 3)
    shapes["conv_last.bias"] = (cin,)
    return shapes


def dense(shapes: dict, name: str, n_out: int, n_in: int) -> None:
    shapes[name + ".weight"] = (n_out, n_in)
    shapes[name + ".bias"] = (n_out,)


def norm(shapes: dict, name: str, c: int) -> None:
    shapes[name + ".weight"] = (c,)
    shapes[name + ".bias"] = (c,)


def ocab_table(net: dict) -> tuple:
    ws = net["window_size"]
    ow = ws + int(net["overlap_ratio"] * ws)
    return ((ws + ow - 1) ** 2, net["num_heads"][0])


# ---- model FLOPs: what ``torch.utils.flop_counter.FlopCounterMode``
# counts on these references, two operations a multiply-add of every
# matrix product and convolution, nothing elementwise

def conv_flops(pix: int, k: int, cin: int, cout: int) -> int:
    return 2 * pix * k * k * cin * cout


def mlp_flops(pix: int, c: int, hid: int) -> int:
    return 4 * pix * c * hid


def ocab_attention_flops(net: dict, pix: int) -> int:
    """The OCAB's two attention products: each query meets ow^2 keys."""
    ws = net["window_size"]
    ow = ws + int(ws * net["overlap_ratio"])
    return 4 * pix * ow * ow * net["embed_dim"]


def shell_flops(net: dict, b: int, h: int, w: int) -> int:
    """conv_first, the residual groups' convs, conv_after_body and the
    pixel-shuffle reconstruction of the HAT shell."""
    c, feat, pix = net["embed_dim"], 64, b * h * w
    total = conv_flops(pix, 3, net["in_chans"], c) + conv_flops(pix, 3, c, c)
    total += len(net["depths"]) * conv_flops(pix, 3, c, c)
    total += conv_flops(pix, 3, c, feat)
    scale, at = net["upscale"], pix
    while scale > 1:
        total += conv_flops(at, 3, feat, 4 * feat)
        at *= 4
        scale //= 2
    return total + conv_flops(at, 3, feat, net["in_chans"])
