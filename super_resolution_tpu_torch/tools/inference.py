"""Folder inference with a built-in model zoo (port of
scripts/inference.py of the JAX package): every image of a folder goes
through the runner the option files use (reflect pad to a window multiple,
whole image or tiles, crop) and is written as ``<stem>_<model>.png``.

    python3 -m super_resolution_tpu_torch.tools.inference --model ESC \
        --scale 4 --weights esc_x4.pth --input ./lq_folder --output ./results

Without ``--weights`` the network runs on its seeded initial weights. The
zoo names every model of the JAX script; one whose architecture the port
does not hold raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
from os import path as osp

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def _esc(n_blocks: int):
    return lambda s: {"type": "ESC", "dim": 64, "pdim": 16, "kernel_size": 13,
                      "n_blocks": n_blocks, "conv_blocks": 5,
                      "window_size": 32, "num_heads": 4,
                      "upscaling_factor": s, "exp_ratio": 1.25}


# model zoo: name -> network options for a scale
MODEL_ZOO = {
    "ESC": _esc(5),
    "ESC-light": _esc(3),
    "ESC-FP": lambda s: {"type": "ESCFP", "dim": 48, "pdim": 16,
                         "kernel_size": 13, "n_blocks": 5, "conv_blocks": 5,
                         "window_size": 32, "num_heads": 3,
                         "upscaling_factor": s, "exp_ratio": 1.25},
    # x4 whatever the scale asked: its nearest + conv head is x4
    "ESC-Real": lambda s: {"type": "ESCReal", "dim": 64, "pdim": 16,
                           "kernel_size": 13, "n_blocks": 10,
                           "conv_blocks": 5, "window_size": 32,
                           "num_heads": 4, "upscaling_factor": 4,
                           "exp_ratio": 2.0},
    "HAT": lambda s: {"type": "HAT", "img_size": 64, "embed_dim": 180,
                      "depths": [6] * 6, "num_heads": [6] * 6,
                      "window_size": 16, "mlp_ratio": 2, "upscale": s,
                      "upsampler": "pixelshuffle"},
    "HAT-S": lambda s: {"type": "HAT", "img_size": 64, "embed_dim": 144,
                        "depths": [6] * 6, "num_heads": [6] * 6,
                        "window_size": 16, "compress_ratio": 24,
                        "squeeze_factor": 24, "mlp_ratio": 2, "upscale": s,
                        "upsampler": "pixelshuffle"},
    # mlp_ratio stays at the architecture's default of 4, as in the JAX
    # package's zoo (the official classical SwinIR-M has 2)
    "SwinIR": lambda s: {"type": "SwinIR", "img_size": 48, "embed_dim": 180,
                         "depths": [6] * 6, "num_heads": [6] * 6,
                         "window_size": 8, "upscale": s,
                         "upsampler": "pixelshuffle"},
}


def network_options(model: str, scale: int) -> dict:
    from super_resolution_tpu_torch import models  # noqa: F401 registry
    from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY

    opts = MODEL_ZOO[model](scale)
    if opts["type"] not in ARCH_REGISTRY:
        raise NotImplementedError(f"model {model!r}: architecture "
                                  f"{opts['type']} is not ported yet")
    return opts


def run(model: str, scale: int, input_dir: str, output_dir: str,
        weights: str | None = None, tile: int = 0, tile_pad: int = 32,
        device: str = "cuda") -> list:
    """Upscale every image of ``input_dir`` into ``output_dir``; returns the
    written paths."""
    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.utils.img import (img2tensor, imread,
                                                      imwrite, tensor2img)
    from super_resolution_tpu_torch.utils.options import process_options

    net = network_options(model, scale)
    # the runner crops to the network's own factor (ESC-Real is x4 at any
    # scale asked)
    scale = net.get("upscaling_factor", net.get("upscale", scale))
    opt = {"name": f"inference_{model}", "model_type": "HATModel",
           "scale": scale, "num_gpu": 1, "manual_seed": 0,
           "network_g": net,
           "datasets": {},
           "path": {"pretrain_network_g": weights,
                    "param_key_g": "params_ema", "strict_load_g": True},
           "val": {}}
    if tile:
        opt["tile"] = {"tile_size": tile, "tile_pad": tile_pad}
    runner = build_model(process_options(opt, ".", is_train=False), device)

    os.makedirs(output_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(input_dir)
                   if n.lower().endswith(IMAGE_SUFFIXES))
    written = []
    for i, name in enumerate(names):
        lq = img2tensor(imread(osp.join(input_dir, name), float32=True))
        runner.feed_data({"lq": lq[None]})
        runner._run_inference()
        out_path = osp.join(output_dir,
                            f"{osp.splitext(name)[0]}_{model}.png")
        imwrite(tensor2img(runner.output), out_path)
        written.append(out_path)
        print(f"[{i + 1}/{len(names)}] {name} -> {out_path}")
    return written


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=sorted(MODEL_ZOO), default="ESC")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--weights", default=None, help="torch .pth")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", default="results")
    parser.add_argument("--tile", type=int, default=0,
                        help="tile size for large images (0 = whole image)")
    parser.add_argument("--tile-pad", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    run(args.model, args.scale, args.input, args.output, args.weights,
        args.tile, args.tile_pad, args.device)


if __name__ == "__main__":
    main()
