"""Folder against folder image quality (port of scripts/eval_folder.py of
the JAX package; the analog of the reference's pyiqa sweep,
HAT/ESC/scripts/compare_real.sh:1-10): PSNR, PSNR-Y and SSIM-Y of a folder
of results against a folder of HR references (the i-th file of each,
sorted, cropped to their common size), and NIQE of each result with at
least one 96 x 96 block after the border crop. Prints one line an image,
then one JSON line ``{"summary": {...}}`` with the means and
``n_images``.

    python3 -m super_resolution_tpu_torch.tools.eval_folder \
        --sr results/foo --hr datasets/GTmod4 [--crop-border 4]

It runs on the host in numpy (the metrics of ``metrics/``); no card is
needed. ``--fid-weights`` raises: FID is not ported.
"""

from __future__ import annotations

import argparse
import json
from os import path as osp


def evaluate(sr_dir: str, hr_dir: str | None = None,
             crop_border: int = 4) -> dict:
    """The summary: each metric's mean over the images, and n_images."""
    from super_resolution_tpu_torch.metrics.niqe import calculate_niqe
    from super_resolution_tpu_torch.metrics.psnr_ssim import (calculate_psnr,
                                                              calculate_ssim)
    from super_resolution_tpu_torch.utils.img import imread
    from super_resolution_tpu_torch.utils.misc import scandir

    sr_paths = sorted(scandir(sr_dir, full_path=True))
    hr_paths = sorted(scandir(hr_dir, full_path=True)) if hr_dir else []
    accum: dict = {}
    for i, sr_path in enumerate(sr_paths):
        sr = imread(sr_path)
        row = {}
        if min(sr.shape[:2]) - 2 * crop_border >= 96:
            row["niqe"] = float(calculate_niqe(sr, crop_border))
        if hr_paths:
            hr = imread(hr_paths[i])
            h = min(sr.shape[0], hr.shape[0])
            w = min(sr.shape[1], hr.shape[1])
            sr_c, hr_c = sr[:h, :w], hr[:h, :w]
            row["psnr"] = float(calculate_psnr(sr_c, hr_c, crop_border))
            row["psnr_y"] = float(calculate_psnr(sr_c, hr_c, crop_border,
                                                 test_y_channel=True))
            row["ssim_y"] = float(calculate_ssim(sr_c, hr_c, crop_border,
                                                 test_y_channel=True))
        for k, v in row.items():
            accum.setdefault(k, []).append(v)
        print(f"{osp.basename(sr_path)}: "
              + " ".join(f"{k}={v:.4f}" for k, v in row.items()))
    summary = {k: sum(v) / len(v) for k, v in accum.items()}
    summary["n_images"] = len(sr_paths)
    return summary


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sr", required=True, help="folder of SR results")
    p.add_argument("--hr", default=None, help="folder of HR references")
    p.add_argument("--crop-border", type=int, default=4)
    p.add_argument("--fid-weights", default=None,
                   help="InceptionV3 weights for FID (not ported)")
    args = p.parse_args(argv)
    if args.fid_weights:
        raise NotImplementedError(
            "--fid-weights: FID (metrics/fid.py with models/inception_arch"
            ".py) is not ported (ROADMAP.md queue 1, item 10)")
    summary = evaluate(args.sr, args.hr, args.crop_border)
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
