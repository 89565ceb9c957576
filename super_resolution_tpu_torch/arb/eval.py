"""Arbitrary-scale evaluation (port of super_resolution_tpu/arb/eval.py;
ref: esc_arb/test.py::batched_predict:16-28, eval_psnr:31-120)."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def batched_predict(model, inp, coord, cell, bsize: int = 30000):
    """Encode once, then query the coordinates ``bsize`` at a time; a head
    without ``gen_feat`` (LTE, MetaSR, LTE+) runs in one call."""
    if not hasattr(model, "gen_feat"):
        return model(inp, coord, cell)
    feat = model.gen_feat(inp)
    return torch.cat([model.query_rgb(feat, coord[:, i:i + bsize],
                                      cell[:, i:i + bsize])
                      for i in range(0, coord.shape[1], bsize)], dim=1)


@torch.no_grad()
def eval_arb(config: dict, model, max_images: int | None = None,
             device: str = "cuda") -> float:
    """The mean PSNR of ``model`` (moved to ``device``, in eval mode) on
    ``config['test_dataset']`` under ``eval_type``'s protocol
    (``benchmark-<s>``: shave s, EDSR luma; ``div2k-<s>``: shave s + 6),
    querying ``eval_bsize`` coordinates at a time, or all at once with
    ``fast_eval`` (the esc_arb test CLI, configs/test/*.yaml). Inputs stay
    in [0, 1]: the reference's ``data_norm`` is not applied, as in JAX."""
    from super_resolution_tpu_torch.data import build_dataset

    ds = build_dataset(dict(config["test_dataset"], phase="val"))
    kind, scale_s = config["eval_type"].rsplit("-", 1)
    scale = int(scale_s)
    protocol = "benchmark" if kind == "benchmark" else "div2k"
    bsize = int(config.get("eval_bsize", 30000))
    one_shot = bool(config.get("fast_eval"))
    model = model.to(device).eval()

    psnrs = []
    n = len(ds) if max_images is None else min(len(ds), max_images)
    for i in range(n):
        item = ds[i]
        inp, coord, cell = (torch.from_numpy(item[k])[None].to(device)
                            for k in ("inp", "coord", "cell"))
        if one_shot:
            pred = model(inp, coord, cell)
        else:
            pred = batched_predict(model, inp, coord, cell, bsize)
        h, w = inp.shape[1] * scale, inp.shape[2] * scale
        sr = pred.float().cpu().numpy().reshape(h, w, -1)
        hr = np.asarray(item["gt"]).reshape(h, w, -1)
        psnrs.append(arb_psnr(sr, hr, dataset=protocol, scale=scale))
    return float(np.mean(psnrs))


def arb_psnr(sr, hr, dataset: str | None = None, scale: int = 1,
             rgb_range: float = 1.0) -> float:
    """esc_arb's PSNR (ref: utils.py:132-150; a copy of the JAX package's
    numpy function): ``benchmark`` shaves ``scale`` and takes the EDSR gray
    luma, ``div2k`` shaves scale + 6. HWC or NHWC arrays."""
    sr = np.asarray(sr)
    hr = np.asarray(hr)
    if sr.ndim == 3:
        sr, hr = sr[None], hr[None]
    diff = (sr - hr) / rgb_range
    if dataset is not None:
        if dataset == "benchmark":
            shave = scale
            if diff.shape[-1] > 1:
                gray = np.array([65.738, 129.057, 25.064]) / 256.0
                diff = (diff * gray).sum(axis=-1, keepdims=True)
        elif dataset == "div2k":
            shave = scale + 6
        else:
            raise NotImplementedError(dataset)
        valid = diff[:, shave:-shave, shave:-shave, :]
    else:
        valid = diff
    mse = float(np.mean(valid ** 2))
    return -10.0 * np.log10(mse)
