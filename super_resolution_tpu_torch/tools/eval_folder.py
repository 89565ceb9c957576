"""Folder against folder image quality (port of scripts/eval_folder.py of
the JAX package; the analog of the reference's pyiqa sweep,
HAT/ESC/scripts/compare_real.sh:1-10): PSNR, PSNR-Y and SSIM-Y of a folder
of results against a folder of HR references (the i-th file of each,
sorted, cropped to their common size), and NIQE of each result with at
least one 96 x 96 block after the border crop. Prints one line an image,
then one JSON line ``{"summary": {...}}`` with the means and
``n_images``; with ``--fid-weights`` (the pt_inception ``.pth``) and
``--hr``, also the FID of the result set against the reference set.

    python3 -m super_resolution_tpu_torch.tools.eval_folder \
        --sr results/foo --hr datasets/GTmod4 [--crop-border 4] \
        [--fid-weights pt_inception.pth] [--device cuda]

The per-image metrics run on the host in numpy (``metrics/``); the FID's
InceptionV3 runs on ``--device`` (``cuda`` unless the caller asks for
``cpu``) on the images as RGB in [0, 1]. The JAX script hands FID the BGR
uint8 reads (ROADMAP.md queue 3).
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


def folder_fid(sr_dir: str, hr_dir: str, weights: str,
               device="cuda") -> float:
    """The FID of every image of ``sr_dir`` against every one of
    ``hr_dir``, read as RGB float32 in [0, 1]."""
    from super_resolution_tpu_torch.metrics.fid import calculate_fid
    from super_resolution_tpu_torch.utils.img import imread
    from super_resolution_tpu_torch.utils.misc import scandir

    def rgb(folder):
        return [imread(p, float32=True)[:, :, ::-1]
                for p in sorted(scandir(folder, full_path=True))]

    return float(calculate_fid(rgb(sr_dir), rgb(hr_dir),
                               inception_weights_path=weights,
                               device=device))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sr", required=True, help="folder of SR results")
    p.add_argument("--hr", default=None, help="folder of HR references")
    p.add_argument("--crop-border", type=int, default=4)
    p.add_argument("--fid-weights", default=None,
                   help="the pt_inception .pth: adds the FID of --sr "
                        "against --hr")
    p.add_argument("--device", default="cuda",
                   help="where the FID's InceptionV3 runs")
    args = p.parse_args(argv)
    summary = evaluate(args.sr, args.hr, args.crop_border)
    if args.fid_weights and args.hr:
        summary["fid"] = folder_fid(args.sr, args.hr, args.fid_weights,
                                    args.device)
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
