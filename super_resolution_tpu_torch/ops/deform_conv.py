"""Modulated deformable convolution (DCNv2), NHWC, in plain PyTorch (port
of super_resolution_tpu/ops/deform_conv.py; ref: basicsr/ops/dcn and
torchvision.ops.deform_conv2d, basicsr/archs/arch_util.py:205-231).

The offsets keep torchvision's layout, as JAX does: for deformable group g
and kernel tap k = i * kw + j, offset channel 2 * (g * kk + k) is dy and
2 * (g * kk + k) + 1 is dx; a corner tap outside the image counts 0. The
sampling is one bilinear gather a tap (the deformable groups folded into
the batch) written into a (B, Ho, Wo, kk, Cin) column tensor, then one
matrix product with the (Cout, kk, Cin) weight. No library deformable
convolution is used.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.grid_sample import bilinear_gather


def modulated_deform_conv2d(x, offset, mask, weight_oihw, bias=None,
                            stride: int = 1, padding: int = 1,
                            dilation: int = 1, deformable_groups: int = 1):
    """x: (B, H, W, Cin); offset: (B, Ho, Wo, 2 * dg * kh * kw); mask:
    (B, Ho, Wo, dg * kh * kw), the modulation after its sigmoid, or None
    (DCNv1); weight_oihw: (Cout, Cin, kh, kw), one group. Returns (B, Ho,
    Wo, Cout)."""
    b, h, w, cin = x.shape
    cout, cin_w, kh, kw = weight_oihw.shape
    if cin_w != cin:
        raise ValueError("grouped deformable convolution is not supported "
                         "(the reference uses groups=1)")
    kk = kh * kw
    dg = deformable_groups
    cg = cin // dg
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1

    off = offset.reshape(b, ho, wo, dg, kk, 2)
    ar = dict(dtype=x.dtype, device=x.device)
    oy = torch.arange(ho, **ar) * stride - padding
    ox = torch.arange(wo, **ar) * stride - padding
    ky = torch.arange(kh, **ar).repeat_interleave(kw) * dilation
    kx = torch.arange(kw, **ar).repeat(kh) * dilation
    xg = x.reshape(b, h, w, dg, cg).permute(0, 3, 1, 2, 4).reshape(
        b * dg, h, w, cg)
    if mask is not None:
        mk = mask.reshape(b, ho, wo, dg, kk)
    cols = x.new_empty(b, ho, wo, kk, dg, cg)
    for k in range(kk):
        iy = (oy[:, None] + ky[k])[None, :, :, None] + off[..., k, 0]
        ix = (ox[None, :] + kx[k])[None, :, :, None] + off[..., k, 1]
        # (B, Ho, Wo, dg) -> (B * dg, Ho, Wo)
        iy = iy.permute(0, 3, 1, 2).reshape(b * dg, ho, wo)
        ix = ix.permute(0, 3, 1, 2).reshape(b * dg, ho, wo)
        tap = bilinear_gather(xg, ix, iy, "zeros")      # (B*dg, Ho, Wo, cg)
        tap = tap.reshape(b, dg, ho, wo, cg).permute(0, 2, 3, 1, 4)
        if mask is not None:
            tap = tap * mk[..., k, None]
        cols[:, :, :, k] = tap
    wr = weight_oihw.permute(0, 2, 3, 1).reshape(cout, kk * cin)
    out = cols.reshape(b * ho * wo, kk * cin) @ wr.t()
    out = out.reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias
    return out


def dcn_offset_mask_from_conv(conv_out, deformable_groups: int):
    """Split a conv_offset output into (offset, mask) as DCNv2Pack does
    (ref: arch_util.py:216-219): thirds o1 | o2 | m along the channels,
    offset = cat(o1, o2), mask = sigmoid(m)."""
    o1, o2, m = torch.chunk(conv_out, 3, dim=-1)
    return torch.cat([o1, o2], dim=-1), torch.sigmoid(m)
