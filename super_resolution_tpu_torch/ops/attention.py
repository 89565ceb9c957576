"""Window attention helpers: relative-position index tables, the shifted
window mask, plain attention with an additive bias and plain multi-head
attention over batched windows.

The numpy builders are copies of super_resolution_tpu/ops/attention.py:23-70
(the port may not import the JAX package). ``attention_with_bias`` keeps
the reference's precision recipe: scores and softmax in float32, the
probabilities cast to v's dtype before P @ V.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def relative_position_index_sa(window_size: int) -> np.ndarray:
    """Swin-style relative position index, (ws^2, ws^2) int32."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1).astype(np.int32)


def relative_position_index_oca(window_size: int,
                                overlap_ratio: float) -> np.ndarray:
    """OCAB query-vs-overlap-window relative index, (ws^2, ow^2) int32."""
    ws = window_size
    we = ws + int(overlap_ratio * ws)
    coords_ori = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                      indexing="ij"))
    flat_ori = coords_ori.reshape(2, -1)
    coords_ext = np.stack(np.meshgrid(np.arange(we), np.arange(we),
                                      indexing="ij"))
    flat_ext = coords_ext.reshape(2, -1)
    rel = flat_ext[:, None, :] - flat_ori[:, :, None]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - we + 1
    rel[:, :, 1] += ws - we + 1
    rel[:, :, 0] *= ws + we - 1
    return rel.sum(-1).astype(np.int32)


def shift_attn_mask(h: int, w: int, window_size: int,
                    shift_size: int) -> np.ndarray:
    """(nW, ws^2, ws^2) additive mask of 0 / -100 for shifted windows."""
    img_mask = np.zeros((h, w))
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[hs, ws_] = cnt
            cnt += 1
    nh, nw = h // window_size, w // window_size
    mw = img_mask.reshape(nh, window_size, nw, window_size)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def shift_attn_mask_tensor(h: int, w: int, window_size: int,
                           shift_size: int, device: str) -> torch.Tensor:
    """``shift_attn_mask`` as a float32 tensor on ``device``, built once per
    shape and shared by every caller, which must not modify it. It is built
    outside inference mode, so that a training forward can save it for its
    backward whichever mode first asked for it."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            shift_attn_mask(h, w, window_size, shift_size)).to(device)


def attention_with_bias(q, k, v, bias, scale=None):
    """softmax(q k^T * scale + bias) v over the last two dims.

    q: (..., Nq, d); k, v: (..., Nk, d); bias broadcastable to
    (..., Nq, Nk). The scores come from operands of the input dtype summed
    in float32, as the reference asks of the MXU.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    attn = attn + bias.float()
    attn = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    attn = attn / attn.sum(dim=-1, keepdim=True)
    return torch.matmul(attn.to(v.dtype), v)


def window_msa(qkv_windows, num_heads: int, bias, scale=None):
    """Multi-head window attention over batched windows: qkv
    (3, B * nW, N, C) -> (B * nW, N, C); bias (num_heads, N, N) or
    broadcastable to (B * nW, num_heads, N, N)."""
    _, bw, n, c = qkv_windows.shape
    d = c // num_heads
    qkv = qkv_windows.reshape(3, bw, n, num_heads, d).permute(0, 1, 3, 2, 4)
    out = attention_with_bias(qkv[0], qkv[1], qkv[2], bias, scale=scale)
    return out.permute(0, 2, 1, 3).reshape(bw, n, c)
