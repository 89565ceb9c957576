"""Arbitrary-scale SR heads, NHWC (port of super_resolution_tpu/arb/
models.py; ref: esc_arb/models/liif.py, lte.py, ltep.py, misc.py, mlp.py,
models.py): a spec registry (``register``, ``make``), grid coordinates, the
nearest-cell gather and the heads ``MLP``, ``LIIF``, ``LTE``, ``MetaSR`` and
``LTEP`` (``lte-fast``).

Coordinates keep the reference's (y, x) order in [-1, 1]. A query's cell is
found by an integer gather at the clamped cell centre (``_nearest_gather``),
what the reference's nearest-mode ``grid_sample`` resolves to; the LTE
heads' bilinear input skip is ``ops/grid_sample.py`` with border padding.
The heads are plain PyTorch; the kernels run in the encoders
(``arb/encoders.py``). Module names follow the reference's torch
checkpoints (``imnet.layers.0``, ``coef``, ``freq``, ``phase``,
``layers.6``), the names the flax bridge gives JAX's parameters.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from super_resolution_tpu_torch.models.arch_util import conv_nhwc
from super_resolution_tpu_torch.models.esc_arch import pointwise
from super_resolution_tpu_torch.ops.conv import shifted_neighborhoods
from super_resolution_tpu_torch.ops.grid_sample import grid_sample_bilinear

models: Dict[str, Any] = {}


def register(name: str):
    def decorator(cls):
        models[name] = cls
        return cls
    return decorator


def make(model_spec: dict, args: dict | None = None):
    """The module of ``{name, args}``, with ``args`` added to the spec's own
    (ref: models.py:14-23)."""
    model_args = dict(model_spec.get("args", {}))
    if args is not None:
        model_args.update(args)
    return models[model_spec["name"]](**model_args)


def make_coord(shape, ranges=None, flatten: bool = True) -> np.ndarray:
    """Grid-centre coordinates in [-1, 1], (y, x) order (ref: utils.py:105;
    a copy of the JAX package's numpy function)."""
    seqs = []
    for i, n in enumerate(shape):
        v0, v1 = (-1, 1) if ranges is None else ranges[i]
        r = (v1 - v0) / (2 * n)
        seqs.append(v0 + r + (2 * r) * np.arange(n, dtype=np.float32))
    grid = np.stack(np.meshgrid(*seqs, indexing="ij"), axis=-1)
    return grid.reshape(-1, len(shape)) if flatten else grid


def to_pixel_samples(img_hwc: np.ndarray):
    """HWC image -> (coord (N, 2), rgb (N, C)) (ref: utils.py:123)."""
    coord = make_coord(img_hwc.shape[:2])
    rgb = img_hwc.reshape(-1, img_hwc.shape[-1])
    return coord, rgb


def _feat_coord(h: int, w: int, like, shift: bool = False):
    """(H, W, 2) cell centres of a feature map on ``like``'s device and
    dtype; ``shift`` moves them by (-1 / h, -1 / w), as MetaSR does."""
    coord = make_coord((h, w), flatten=False)
    if shift:
        coord[:, :, 0] -= 1.0 / h
        coord[:, :, 1] -= 1.0 / w
    return torch.from_numpy(coord).to(like.device, like.dtype)


def _nearest_gather(feat, coord):
    """feat (B, H, W, C) at normalised (y, x) coords (B, Q, 2) -> (B, Q,
    C): the cell whose centre is nearest, clamped to the map; the
    reference's ``grid_sample(..., mode='nearest', align_corners=False)``.
    ``feat`` may be an (H, W, C) map shared by the batch."""
    h, w = feat.shape[-3], feat.shape[-2]
    iy = torch.floor((coord[..., 0] + 1) / 2 * h).clamp(0, h - 1).long()
    ix = torch.floor((coord[..., 1] + 1) / 2 * w).clamp(0, w - 1).long()
    if feat.dim() == 3:
        return feat[iy, ix]
    bidx = torch.arange(feat.shape[0], device=feat.device)[:, None]
    return feat[bidx, iy, ix]


def _unfold3(feat):
    """3 x 3 neighbourhoods, zero outside, channel-major: (B, H, W, 9C) in
    the reference's ``F.unfold`` order (C, kh, kw)."""
    b, h, w, c = feat.shape
    return shifted_neighborhoods(feat, 3).transpose(3, 4).reshape(b, h, w,
                                                                 9 * c)


def _ensemble(preds, areas):
    """sum of pred * area / total over the four neighbours, each weighted
    by the area of the diagonally opposite one (the reference's swap)."""
    tot = sum(areas)
    areas = [areas[3], areas[2], areas[1], areas[0]]
    out = 0
    for pred, area in zip(preds, areas):
        out = out + pred * (area / tot)[..., None]
    return out


def _shift(vx: int, vy: int, h: int, w: int, eps: float, like):
    return torch.tensor([vx / h + eps, vy / w + eps], dtype=like.dtype,
                        device=like.device)


def _hw(h: int, w: int, like):
    return torch.tensor([h, w], dtype=like.dtype, device=like.device)


@register("mlp")
class MLP(nn.Module):
    """Linear + ReLU layers (``layers.{2i}``), a last Linear to out_dim."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_list: Sequence[int]):
        super().__init__()
        layers, last = [], in_dim
        for hidden in hidden_list:
            layers += [nn.Linear(last, hidden), nn.ReLU()]
            last = hidden
        layers.append(nn.Linear(last, out_dim))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


@register("liif")
class LIIF(nn.Module):
    """Local implicit image function (ref: liif.py:10-110): the encoder's
    feature map (3 x 3-unfolded with ``feat_unfold``), gathered at each
    query's cell and, with ``local_ensemble``, its three neighbours, with
    the relative coordinate (and, with ``cell_decode``, the query's cell
    size) through ``imnet``, blended by the swapped areas. Without
    ``imnet_spec`` a query takes its cell's feature."""

    def __init__(self, encoder_spec: dict, imnet_spec: dict | None = None,
                 local_ensemble: bool = True, feat_unfold: bool = True,
                 cell_decode: bool = True):
        super().__init__()
        self.local_ensemble = local_ensemble
        self.feat_unfold = feat_unfold
        self.cell_decode = cell_decode
        self.encoder = make(encoder_spec)
        self.imnet = None
        if imnet_spec is not None:
            in_dim = self.encoder.out_dim * (9 if feat_unfold else 1) + 2
            if cell_decode:
                in_dim += 2
            self.imnet = make(imnet_spec, args={"in_dim": in_dim})

    def gen_feat(self, inp):
        return self.encoder(inp)

    def query_rgb(self, feat, coord, cell=None):
        if self.imnet is None:
            return _nearest_gather(feat, coord)
        b, h, w, _ = feat.shape
        if self.feat_unfold:
            feat = _unfold3(feat)
        if self.local_ensemble:
            vx_lst, vy_lst, eps = (-1, 1), (-1, 1), 1e-6
        else:
            vx_lst, vy_lst, eps = (0,), (0,), 0
        feat_coord = _feat_coord(h, w, coord)
        hw = _hw(h, w, coord)
        preds, areas = [], []
        for vx in vx_lst:
            for vy in vy_lst:
                coord_ = (coord + _shift(vx, vy, h, w, eps, coord)).clamp(
                    -1 + 1e-6, 1 - 1e-6)
                rel = (coord - _nearest_gather(feat_coord, coord_)) * hw
                inp = [_nearest_gather(feat, coord_), rel]
                if self.cell_decode:
                    inp.append(cell * hw)
                preds.append(self.imnet(torch.cat(inp, dim=-1)))
                areas.append((rel[..., 0] * rel[..., 1]).abs() + 1e-9)
        # one neighbour weighs area / area = 1
        return _ensemble(preds, areas) if self.local_ensemble else preds[0]

    def forward(self, inp, coord, cell):
        return self.query_rgb(self.gen_feat(inp), coord, cell)


class _LTEBase(nn.Module):
    """The encoder and LTE's amplitude, frequency and phase estimators."""

    def __init__(self, encoder_spec: dict, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.encoder = make(encoder_spec)
        self.coef = nn.Conv2d(self.encoder.out_dim, hidden_dim, 3, 1, 1)
        self.freq = nn.Conv2d(self.encoder.out_dim, hidden_dim, 3, 1, 1)
        self.phase = nn.Linear(2, hidden_dim // 2, bias=False)

    def estimate(self, inp):
        feat = self.encoder(inp)
        return conv_nhwc(self.coef, feat), conv_nhwc(self.freq, feat)

    def neighbours(self, coef, freq, coord):
        """For each of the four neighbour cells of every query: (q_coef,
        q_freq, rel), rel the query's offset from the cell centre in
        cells."""
        _, h, w, _ = coef.shape
        feat_coord = _feat_coord(h, w, coord)
        hw = _hw(h, w, coord)
        for vx in (-1, 1):
            for vy in (-1, 1):
                coord_ = (coord + _shift(vx, vy, h, w, 1e-6, coord)).clamp(
                    -1 + 1e-6, 1 - 1e-6)
                rel = (coord - _nearest_gather(feat_coord, coord_)) * hw
                yield (_nearest_gather(coef, coord_),
                       _nearest_gather(freq, coord_), rel, hw)

    @staticmethod
    def skip(inp, coord):
        """The input sampled bilinearly at the queries (border padding),
        (B, Q, C)."""
        grid = torch.stack([coord[..., 1], coord[..., 0]], dim=-1)
        return grid_sample_bilinear(inp, grid[:, :, None, :])[:, :, 0, :]


@register("lte")
class LTE(_LTEBase):
    """Local texture estimator (ref: lte.py:11-110): amplitude and frequency
    maps from 3 x 3 convs of the encoder's features; at a query the
    frequencies, in interleaved (y, x) pairs, meet the relative coordinate,
    the phase comes from the cell size, and ``imnet`` decodes amplitude x
    [cos, sin]; the local ensemble, plus the bilinear input skip."""

    def __init__(self, encoder_spec: dict, imnet_spec: dict | None = None,
                 hidden_dim: int = 256):
        super().__init__(encoder_spec, hidden_dim)
        self.imnet = make(imnet_spec, args={"in_dim": hidden_dim})

    def forward(self, inp, coord, cell):
        coef, freq = self.estimate(inp)
        preds, areas = [], []
        for q_coef, q_freq, rel, hw in self.neighbours(coef, freq, coord):
            qf = q_freq.reshape(*q_freq.shape[:2], self.hidden_dim // 2, 2)
            qf = (qf * rel[..., None, :]).sum(-1) + self.phase(cell * hw)
            qf = torch.cat([torch.cos(math.pi * qf),
                            torch.sin(math.pi * qf)], dim=-1)
            preds.append(self.imnet(q_coef * qf))
            areas.append((rel[..., 0] * rel[..., 1]).abs() + 1e-9)
        return _ensemble(preds, areas) + self.skip(inp, coord)


@register("metasr")
class MetaSR(nn.Module):
    """Meta-upscale (ref: misc.py:11-70): per query, ``imnet`` maps the
    offset from the (shifted) cell centre and the cell size to a (9C, 3)
    filter, applied to the 3 x 3-unfolded feature of the query's cell."""

    def __init__(self, encoder_spec: dict):
        super().__init__()
        self.encoder = make(encoder_spec)
        self.imnet = MLP(3, self.encoder.out_dim * 9 * 3, (256,))

    def forward(self, inp, coord, cell):
        feat = self.encoder(inp)
        _, h, w, c = feat.shape
        feat9 = _unfold3(feat)
        feat_coord = _feat_coord(h, w, coord, shift=True)
        coord_ = coord - cell / 2
        coord_q = (coord_ + 1e-6).clamp(-1 + 1e-6, 1 - 1e-6)
        rel = (coord_ - _nearest_gather(feat_coord, coord_q)) * torch.tensor(
            [h / 2, w / 2], dtype=coord.dtype, device=coord.device)
        r_rev = cell[..., 0] * (h / 2)
        pred_w = self.imnet(torch.cat([rel, r_rev[..., None]], dim=-1))
        pred_w = pred_w.reshape(*coord.shape[:2], c * 9, 3)
        return torch.einsum("bqk,bqko->bqo", _nearest_gather(feat9, coord_q),
                            pred_w)


@register("lte-fast")
class LTEP(_LTEBase):
    """LTE+ (ref: ltep.py:13-110): LTE on a (B, Hq, Wq, 2) query grid with
    one (B, 2) cell a sample, its frequencies split in two halves (y, x),
    not LTE's interleaved pairs, and a head of 1 x 1 convs over the grid
    (``layers.{2i}``); the bilinear input skip at the end."""

    def __init__(self, encoder_spec: dict, num_layer: int = 3,
                 hidden_dim: int = 256, out_dim: int = 3):
        super().__init__(encoder_spec, hidden_dim)
        layers = []
        for _ in range(num_layer):
            layers += [nn.Conv2d(hidden_dim, hidden_dim, 1), nn.ReLU()]
        layers.append(nn.Conv2d(hidden_dim, out_dim, 1))
        self.layers = nn.Sequential(*layers)

    def head(self, y):
        for i in range(0, len(self.layers), 2):
            y = pointwise(self.layers[i], y)
            if i + 1 < len(self.layers):
                y = torch.relu(y)
        return y

    def forward(self, inp, coord, cell):
        coef, freq = self.estimate(inp)
        b = coef.shape[0]
        hq, wq = coord.shape[1], coord.shape[2]
        coord_flat = coord.reshape(b, hq * wq, 2)
        half = self.hidden_dim // 2
        preds, areas = [], []
        for q_coef, q_freq, rel, hw in self.neighbours(coef, freq,
                                                       coord_flat):
            qf = q_freq.reshape(b, hq * wq, 2, half)
            qf = (qf * rel[..., :, None]).sum(2) + self.phase(
                cell * hw)[:, None, :]
            qf = torch.cat([torch.cos(math.pi * qf),
                            torch.sin(math.pi * qf)], dim=-1)
            preds.append(self.head((q_coef * qf).reshape(b, hq, wq, -1)))
            areas.append(((rel[..., 0] * rel[..., 1]).abs() + 1e-9)
                         .reshape(b, hq, wq))
        skip = self.skip(inp, coord_flat).reshape(b, hq, wq, -1)
        return _ensemble(preds, areas) + skip
