"""FID, the Frechet Inception Distance (port of super_resolution_tpu/
metrics/fid.py; ref: basicsr/metrics/fid.py:1-90).

The features are the FID-patched InceptionV3's (``models/
inception_arch.py``) on the device the caller names. No weights come with
the port and none are downloaded: the pt_inception checkpoint
(pt_inception-2015-12-05-6726825d.pth) is given by path or as a state
dict. FID is a statistic of two SETS of images and is not in
``METRIC_REGISTRY``'s per-image dispatch: use :func:`calculate_fid`
(``tools/eval_folder.py --fid-weights``) or the pieces below. The
statistics and the distance run in numpy / scipy on the host, copies of
the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
from scipy import linalg


def calculate_frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                               mu2: np.ndarray, sigma2: np.ndarray,
                               eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with an eps
    offset on the diagonals where the root is not finite."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component in matrix sqrt")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_statistics(features: np.ndarray):
    """(N, D) activations -> (mu, sigma)."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def extract_inception_features(images: Iterable[np.ndarray],
                               feature_fn: Callable[[np.ndarray], np.ndarray],
                               batch_size: int = 32) -> np.ndarray:
    """``feature_fn`` over batches of HWC float32 RGB images in [0, 1];
    a batch of mixed sizes goes an image at a time. (N, D)."""
    feats = []
    batch: list = []

    def flush():
        if not batch:
            return
        if all(b.shape == batch[0].shape for b in batch):
            feats.append(np.asarray(feature_fn(np.stack(batch))))
        else:
            feats.extend(np.asarray(feature_fn(b[None])) for b in batch)
        batch.clear()

    for img in images:
        batch.append(np.asarray(img, np.float32))
        if len(batch) == batch_size:
            flush()
    flush()
    return np.concatenate(feats, axis=0)


def load_patched_inception_v3(weights_path: str | None = None,
                              resize_input: bool = True,
                              normalize_input: bool = False,
                              output_blocks: Sequence[int] = (3,),
                              state_dict: dict | None = None,
                              device="cuda") -> Callable:
    """The FID feature function: (N, H, W, 3) numpy -> the last output
    block flattened, (N, 2048) for block 3, float32, computed on
    ``device``. Weights: ``weights_path`` (the pt_inception ``.pth``, raw or
    wrapper layout) or ``state_dict``; one is required."""
    import torch

    from super_resolution_tpu_torch.models.inception_arch import (
        FIDInceptionV3, load_fid_inception)

    if state_dict is None:
        if weights_path is None:
            raise ValueError(
                "FID needs InceptionV3 weights: pass weights_path (the "
                "pt_inception checkpoint) or a state_dict; none is "
                "downloaded")
        state_dict = torch.load(weights_path, map_location="cpu",
                                weights_only=True)
        if isinstance(state_dict, dict) and "state_dict" in state_dict:
            state_dict = state_dict["state_dict"]
    net = FIDInceptionV3(output_blocks=tuple(output_blocks),
                         resize_input=resize_input,
                         normalize_input=normalize_input)
    load_fid_inception(net, state_dict)
    net = net.to(device).eval()

    @torch.inference_mode()
    def feature_fn(imgs):
        x = torch.as_tensor(np.ascontiguousarray(imgs, np.float32),
                            device=device)
        out = net(x)[-1]
        return out.reshape(out.shape[0], -1).float().cpu().numpy()

    return feature_fn


def calculate_fid(imgs1: Sequence[np.ndarray], imgs2: Sequence[np.ndarray],
                  inception_weights_path: str | None = None,
                  feature_fn: Callable | None = None,
                  batch_size: int = 32, device="cuda") -> float:
    """FID between two image sets (HWC float [0, 1] each), at least two
    images a side (realistically, a dataset's worth)."""
    if len(imgs1) < 2 or len(imgs2) < 2:
        raise ValueError("FID is a set statistic: give >=2 images per side "
                         "(realistically, a full dataset)")
    if feature_fn is None:
        feature_fn = load_patched_inception_v3(
            inception_weights_path, resize_input=True, normalize_input=True,
            device=device)
    f1 = extract_inception_features(imgs1, feature_fn, batch_size)
    f2 = extract_inception_features(imgs2, feature_fn, batch_size)
    return calculate_frechet_distance(*compute_statistics(f1),
                                      *compute_statistics(f2))
