"""Differentiable JPEG compression and decompression on NHWC tensors (port
of super_resolution_tpu/ops/diffjpeg.py; ref: basicsr/utils/diffjpeg.py
:449-492): JPEG's YCbCr, 2 x 2 chroma subsampling, the 8 x 8 orthonormal
DCT-II as O B O^T, the Annex K tables scaled by the quality, rounding
(differentiable: ``diff_round``), then the inverse path.
"""

from __future__ import annotations

import numpy as np
import torch

# the Annex K tables, transposed as the reference stores them
# (diffjpeg.py:14-23; the quantisation depends on that orientation)
Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32).T

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                            [24, 26, 56, 99], [47, 66, 99, 99]],
                           dtype=np.float32).T

_RGB2YCBCR = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], dtype=np.float32)
_YCBCR_SHIFT = np.array([0.0, 128.0, 128.0], dtype=np.float32)
_YCBCR2RGB = np.array([[1.0, 0.0, 1.402],
                       [1.0, -0.344136, -0.714136],
                       [1.0, 1.772, 0.0]], dtype=np.float32)


def _dct_ortho_matrix() -> np.ndarray:
    """The orthonormal DCT-II matrix O (8 x 8):
    O[u, x] = a_u / 2 cos((2x + 1) u pi / 16)."""
    x = np.arange(8)
    u = np.arange(8)
    c = np.cos((2 * x[None, :] + 1) * u[:, None] * np.pi / 16)
    alpha = np.ones(8)
    alpha[0] = 1 / np.sqrt(2)
    return (alpha[:, None] / 2.0 * c).astype(np.float32)


_O = _dct_ortho_matrix()


def diff_round(x):
    """round(x) + (x - round(x))^3: gradient 1 at the integers (ref:
    diffjpeg.py:26-29)."""
    r = torch.round(x)
    return r + (x - r) ** 3


def quality_to_factor(quality):
    """JPEG quality (1 .. 100) -> the tables' scale (ref: :32-45)."""
    q = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(q < 50, 5000.0 / q, 200.0 - 2.0 * q) / 100.0


def _to_blocks(x):
    """(B, H, W) -> (B, nb, 8, 8)."""
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, -1, 8, 8)


def _from_blocks(x, h: int, w: int):
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h, w)


def _dct(blocks, o):
    return torch.einsum("ux,bnxy,vy->bnuv", o, blocks - 128.0, o)


def _idct(coefs, o):
    # B = O^T F O: the weights a_u go with the frequencies (u, v)
    return torch.einsum("ux,bnuv,vy->bnxy", o, coefs, o) + 128.0


def _quant_channel(plane, table, factor, rounding, o):
    """plane (B, H, W) -> the quantised blocks (B, nb, 8, 8) and the scaled
    table."""
    blocks = _dct(_to_blocks(plane), o)
    t = table[None, None] * factor[:, None, None, None]
    return rounding(blocks / t), t


def jpeg_compress_decompress(img, quality, differentiable: bool = True):
    """JPEG round trip of ``img`` (B, H, W, 3), RGB in [0, 1], at
    ``quality``, a number or one a sample (B,). Returns (B, H, W, 3) in
    [0, 1]."""
    b, h, w, _ = img.shape
    dev, dt = img.device, img.dtype
    factor = quality_to_factor(
        torch.as_tensor(quality, dtype=torch.float32, device=dev)
        .broadcast_to((b,))).to(dt)
    rounding = diff_round if differentiable else torch.round

    def const(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    o = const(_O)
    pad_h, pad_w = (-h) % 16, (-w) % 16
    if pad_h or pad_w:
        img = torch.nn.functional.pad(img, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = img.shape[1], img.shape[2]

    # RGB -> JPEG YCbCr on the 255 scale
    ycc = (img * 255.0) @ const(_RGB2YCBCR).T + const(_YCBCR_SHIFT)
    y = ycc[..., 0]
    # 2 x 2 average chroma subsampling
    cb = ycc[..., 1].reshape(b, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))
    cr = ycc[..., 2].reshape(b, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))

    yq, yt = _quant_channel(y, const(Y_TABLE), factor, rounding, o)
    cbq, ct = _quant_channel(cb, const(C_TABLE), factor, rounding, o)
    crq, _ = _quant_channel(cr, const(C_TABLE), factor, rounding, o)

    # decompress: dequantise, inverse DCT, merge
    y_rec = _from_blocks(_idct(yq * yt, o), hp, wp)
    cb_rec = _from_blocks(_idct(cbq * ct, o), hp // 2, wp // 2)
    cr_rec = _from_blocks(_idct(crq * ct, o), hp // 2, wp // 2)

    # nearest chroma upsampling (each value to 2 x 2)
    cb_up = cb_rec.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr_up = cr_rec.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    ycc_rec = torch.stack([y_rec, cb_up - 128.0, cr_up - 128.0], dim=-1)
    rgb = ycc_rec @ const(_YCBCR2RGB).T
    rgb = torch.clamp(rgb, 0.0, 255.0) / 255.0
    return rgb[:, :h, :w, :]
