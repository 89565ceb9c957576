"""VGG19 feature extractor for the perceptual loss (port of
super_resolution_tpu/models/vgg_arch.py; ref: basicsr/archs/vgg_arch.py).

The network is torchvision's VGG19 (cfg 'E') cut after the deepest layer
asked for, under torchvision's module names (``features.N``), so the
weights of torchvision's ``vgg19`` .pth load into it strict: every
parameter of the cut network must be in the file, and the file's deeper
layers and classifier are passed over. No weights come with the port, and
none are downloaded: the caller names the file.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# torchvision's vgg19 cfg 'E' with basicsr's layer names; a layer's position
# is its index in torchvision's ``features``
VGG19_LAYERS = [
    "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
    "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
    "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3", "relu3_3",
    "conv3_4", "relu3_4", "pool3",
    "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3",
    "conv4_4", "relu4_4", "pool4",
    "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
    "conv5_4", "relu5_4", "pool5",
]
_VGG19_CHANNELS = {"1": 64, "2": 128, "3": 256, "4": 512, "5": 512}

# ImageNet normalisation (ref: vgg_arch.py VGGFeatureExtractor)
VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)


def vgg19_layers(last: int) -> list:
    """torchvision's ``features`` modules 0 .. ``last``."""
    layers, in_ch = [], 3
    for name in VGG19_LAYERS[:last + 1]:
        if name.startswith("conv"):
            out_ch = _VGG19_CHANNELS[name[4]]
            layers.append(nn.Conv2d(in_ch, out_ch, 3, 1, 1))
            in_ch = out_ch
        elif name.startswith("relu"):
            layers.append(nn.ReLU())
        else:
            layers.append(nn.MaxPool2d(2, 2))
    return layers


def seeded_vgg19_state_dict(seed: int = 0) -> dict:
    """Random VGG19 weights under torchvision's names (He-normal convs,
    small biases, the classifier's first layer as a stand-in), from a
    seeded CPU generator: what a run without the trained file loads (a
    step's cost does not depend on the values)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for idx, layer in enumerate(vgg19_layers(len(VGG19_LAYERS) - 1)):
        if isinstance(layer, nn.Conv2d):
            cin, cout = layer.in_channels, layer.out_channels
            sd[f"features.{idx}.weight"] = torch.randn(
                cout, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5
            sd[f"features.{idx}.bias"] = torch.randn(cout, generator=g) * 0.01
    sd["classifier.0.weight"] = torch.zeros(8, 8)
    return sd


class VGGFeatureExtractor(nn.Module):
    """VGG19 up to the deepest layer of ``layer_name_list`` (basicsr names,
    e.g. ``conv5_4``, ``relu4_4``). ``forward`` takes NHWC RGB in [0, 1]
    (in [-1, 1] with ``range_norm``) and returns {name: NCHW feature}."""

    def __init__(self, layer_name_list: Sequence[str],
                 use_input_norm: bool = True, range_norm: bool = False):
        super().__init__()
        self.layer_name_list = list(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        last = max(VGG19_LAYERS.index(n) for n in self.layer_name_list)
        self.features = nn.Sequential(*vgg19_layers(last))
        self.register_buffer("mean", torch.tensor(VGG_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(VGG_STD).view(1, 3, 1, 1),
                             persistent=False)

    def load_torchvision(self, state: dict) -> None:
        """Load torchvision's vgg19 state dict: the ``features.N`` entries
        this network has, each of which must be there."""
        own = self.state_dict()
        missing = [k for k in own if k not in state]
        if missing:
            raise KeyError(f"VGG19 weights lack {missing}")
        self.load_state_dict({k: state[k] for k in own})

    def forward(self, x) -> dict:
        x = x.permute(0, 3, 1, 2)
        if self.range_norm:
            x = (x + 1) / 2
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        out = {}
        for name, layer in zip(VGG19_LAYERS, self.features):
            x = layer(x)
            if name in self.layer_name_list:
                out[name] = x
        return out
