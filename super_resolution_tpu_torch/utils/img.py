"""Image conversion with the reference's rounding, and image file IO
(port of super_resolution_tpu/utils/img.py). cv2 is imported only by the
file functions, so in-memory use needs no OpenCV."""

from __future__ import annotations

import os

import numpy as np


def tensor2img(x, rgb2bgr: bool = True, min_max=(0, 1)) -> np.ndarray:
    """NHWC or HWC [0, 1] float array (numpy or torch) -> uint8 BGR HWC:
    clamp, normalise, * 255, round, uint8. A batch of one is squeezed."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 4:
        if x.shape[0] != 1:
            return np.stack([tensor2img(v, rgb2bgr, min_max) for v in x])
        x = x[0]
    x = np.clip(x, min_max[0], min_max[1])
    x = (x - min_max[0]) / (min_max[1] - min_max[0])
    if x.ndim == 3 and x.shape[2] == 3 and rgb2bgr:
        x = x[:, :, ::-1]
    return (x * 255.0).round().astype(np.uint8)


def img2tensor(img: np.ndarray, bgr2rgb: bool = True) -> np.ndarray:
    """uint8 (or float) BGR HWC image -> float32 RGB HWC in [0, 1]."""
    img = img.astype(np.float32)
    if img.max() > 1.01:
        img = img / 255.0
    if img.ndim == 3 and img.shape[2] == 3 and bgr2rgb:
        img = img[:, :, ::-1]
    elif img.ndim == 2:
        img = img[:, :, None]
    return np.ascontiguousarray(img)


def imread(path: str, float32: bool = False) -> np.ndarray:
    """Read an image as BGR HWC uint8; float32 scales to [0, 1]."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"Failed to read image: {path}")
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> None:
    """Write a BGR HWC uint8 image, creating parent directories."""
    import cv2

    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    if not cv2.imwrite(file_path, img):
        raise IOError(f"Failed to write image: {file_path}")


def imfrombytes(content: bytes, float32: bool = False,
                flag: str = "color") -> np.ndarray:
    """Decode encoded image bytes (the LMDB / memcached read path) to BGR
    HWC, uint8 or with ``float32`` in [0, 1], as :func:`imread`. flag:
    'color', 'grayscale' or 'unchanged' (ref: img_util.py::imfrombytes)."""
    import cv2

    flags = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}[flag]
    img = cv2.imdecode(np.frombuffer(content, np.uint8), flags)
    if img is None:
        raise ValueError("cv2.imdecode could not decode the bytes")
    if float32:
        img = img.astype(np.float32) / 255.0
    return img
