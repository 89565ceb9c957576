"""Tiny configurations and mixes of the benchmark's CPU tests: the cells'
structure at widths and sizes a CPU test holds."""

NET = dict(upscale=4, in_chans=3, img_size=16, window_size=8,
           compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
           overlap_ratio=0.5, img_range=1.0, depths=[2, 2], embed_dim=24,
           num_heads=[2, 2], mlp_ratio=2, upsampler="pixelshuffle",
           resi_connection="1conv")
NETS = {"HATClassic": dict(NET, type="HATClassic"),
        "HAT": dict(NET, type="HAT", esc_pdim=8, esc_kernel=5,
                    ocab_esc_enable=False)}
REFERENCES = {"HATClassic": "hat_classic", "HAT": "hat_fork"}


def config(kind: str) -> dict:
    return dict(model_type="HATModel", scale=4, network_g=NETS[kind],
                val={"inference_dtype": "bf16"}, reference=REFERENCES[kind])


# a tiled mix (two tile shapes, chunks of 2) and a whole-image one
TILED = dict(driver="serve_closed_loop", shapes=[{"lr": [20, 40], "weight": 1},
                     {"lr": [24, 24], "weight": 2}],
             tile={"tile_size": 16, "tile_pad": 4, "chunk": 2},
             check={"requests": 2})
WHOLE = dict(driver="serve_closed_loop", shapes=[{"lr": [20, 28], "weight": 1},
                     {"lr": [16, 16], "weight": 1}],
             tile=None, check={"requests": 2})
