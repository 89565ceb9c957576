"""HiFaceGAN: a SPADE generator with a local-importance-pooling encoder and
a multiscale PatchGAN discriminator (port of super_resolution_tpu/models/
hifacegan_arch.py; ref: basicsr/archs/hifacegan_arch.py:10-260,
hifacegan_util.py:12-255).

NHWC in and out, NCHW inside. The spectral-norm convs hold torch's stored
vectors and use them as its eval mode does, in every mode
(:class:`~super_resolution_tpu_torch.models.arch_util.
StoredSpectralNormConv2d`). SPADE runs instance norm for ``syncbatch`` as
well, as the JAX package and the reference on one GPU do. Names follow
BasicSR's checkpoint; the generator keeps the ``fc`` conv and the four
``to_rgbs`` even where the forward uses one of them, as BasicSR's does
(the JAX tree has only the ones its forward calls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from super_resolution_tpu_torch.models.arch_util import \
    StoredSpectralNormConv2d as SNConv
from super_resolution_tpu_torch.ops.pool import avg_pool2d
from super_resolution_tpu_torch.utils.registry import ARCH_REGISTRY


def nearest_resize(x, out_h: int, out_w: int):
    """Nearest resize with source index floor(i in / out), torch's
    ``F.interpolate(mode='nearest')``."""
    return F.interpolate(x, size=(out_h, out_w), mode="nearest")


def _nearest2x(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


def avg_pool_valid(x):
    """3 x 3 / 2 average pool whose divisor counts only the taps inside the
    image (``count_include_pad=False``)."""
    return avg_pool2d(x, 3, 2, 1, count_include_pad=False)


def lip2d(x, logit, kernel: int = 3, stride: int = 2, padding: int = 1):
    """Local importance pooling: pool(x e^logit) / pool(e^logit) (ref:
    hifacegan_util.py:154-156); the two pools' divisors cancel."""
    w = logit.exp()
    return (avg_pool2d(x * w, kernel, stride, padding)
            / avg_pool2d(w, kernel, stride, padding))


class SPADE(nn.Module):
    """Spatially-adaptive denormalisation (ref: hifacegan_util.py:12-54):
    instance norm(x) * gamma(seg) + beta(seg)."""

    def __init__(self, norm_nc: int, label_nc: int, ks: int = 3):
        super().__init__()
        nhidden = 128 if norm_nc > 128 else norm_nc
        pw = ks // 2
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, nhidden, ks, padding=pw), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=pw,
                                   bias=False)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=pw,
                                  bias=False)

    def forward(self, x, segmap):
        segmap = nearest_resize(segmap, x.shape[2], x.shape[3])
        actv = self.mlp_shared(segmap)
        return (F.instance_norm(x) * self.mlp_gamma(actv)
                + self.mlp_beta(actv))


class SPADEResnetBlock(nn.Module):
    """(ref: hifacegan_util.py:57-110)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = SNConv(fin, fmiddle, 3, padding=1)
        self.conv_1 = SNConv(fmiddle, fout, 3, padding=1)
        self.norm_0 = SPADE(fin, 3)
        self.norm_1 = SPADE(fmiddle, 3)
        if self.learned_shortcut:
            self.conv_s = SNConv(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin, 3)

    def forward(self, x, seg):
        x_s = (self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut
               else x)
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx


class SoftGate(nn.Module):
    def forward(self, x):
        return torch.sigmoid(x) * 12.0


class SimplifiedLIP(nn.Module):
    """(ref: hifacegan_util.py:166-179)."""

    def __init__(self, channels: int):
        super().__init__()
        self.logit = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1, bias=False),
            nn.InstanceNorm2d(channels, affine=True), SoftGate())

    def forward(self, x):
        return lip2d(x, self.logit(x))


class LIPEncoder(nn.Module):
    """(ref: hifacegan_util.py:182-214)."""

    def __init__(self, input_nc: int, ngf: int, n_2xdown: int):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ngf, 3, padding=1, bias=False),
                  nn.InstanceNorm2d(ngf), nn.ReLU()]
        cur_ratio = 1
        for i in range(n_2xdown):
            next_ratio = min(cur_ratio * 2, 16)
            layers += [SimplifiedLIP(ngf * cur_ratio),
                       nn.Conv2d(ngf * cur_ratio, ngf * next_ratio, 3,
                                 padding=1),
                       nn.InstanceNorm2d(ngf * next_ratio)]
            cur_ratio = next_ratio
            if i < n_2xdown - 1:
                layers.append(nn.ReLU())
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


@ARCH_REGISTRY.register()
class SPADEGenerator(nn.Module):
    """The SPADE generator (ref: hifacegan_arch.py:10-94): the input,
    resized to 1/32, through ``fc``; three SPADE blocks at 16 nf; then x2
    and a SPADE block per phase, the phase's ``to_rgbs`` and tanh."""

    scale_ratio = 5

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 use_vae: bool = False, z_dim: int = 256,
                 crop_size: int = 512,
                 norm_g: str = "spectralspadesyncbatch3x3",
                 is_train: bool = True, init_train_phase: int = 3):
        super().__init__()
        if use_vae:
            raise NotImplementedError(
                "use_vae: the reference's VAE encoder is not built. JAX's "
                "generator takes the field and ignores it (the same network "
                "as use_vae false); the port refuses it rather than train "
                "another network than the options name")
        nf = num_feat
        self.is_train, self.init_train_phase = is_train, init_train_phase
        self.fc = nn.Conv2d(num_in_ch, 16 * nf, 3, padding=1)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf)
        self.g_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf)
        self.g_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf)
        self.ups = nn.ModuleList([SPADEResnetBlock(16 * nf, 8 * nf),
                                  SPADEResnetBlock(8 * nf, 4 * nf),
                                  SPADEResnetBlock(4 * nf, 2 * nf),
                                  SPADEResnetBlock(2 * nf, nf)])
        self.to_rgbs = nn.ModuleList([
            nn.Conv2d(c * nf, 3, 3, padding=1) for c in (8, 4, 2, 1)])

    def encode(self, x):
        s = 2 ** self.scale_ratio
        return self.fc(nearest_resize(x, x.shape[2] // s, x.shape[3] // s))

    def forward(self, x):
        seg = x.permute(0, 3, 1, 2)
        x = self.encode(seg)
        x = self.head_0(x, seg)
        x = _nearest2x(x)
        x = self.g_middle_0(x, seg)
        x = self.g_middle_1(x, seg)
        phase = (self.init_train_phase + 1 if self.is_train
                 else len(self.to_rgbs))
        for i in range(phase):
            x = self.ups[i](_nearest2x(x), seg)
        x = self.to_rgbs[phase - 1](F.leaky_relu(x, 0.2))
        return torch.tanh(x).permute(0, 2, 3, 1)


@ARCH_REGISTRY.register()
class HiFaceGAN(SPADEGenerator):
    """The SPADE generator with the LIP encoder (ref:
    hifacegan_arch.py:144-164)."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, **kwargs):
        super().__init__(num_in_ch, num_feat, **kwargs)
        self.lip_encoder = LIPEncoder(num_in_ch, num_feat, self.scale_ratio)

    def encode(self, x):
        return self.lip_encoder(x)


class NLayerDiscriminator(nn.Module):
    """PatchGAN with spectral norm and instance norm (ref:
    hifacegan_arch.py:223-260): the features of every layer."""

    def __init__(self, input_nc: int, n_layers_d: int, num_feat: int):
        super().__init__()
        self.n_layers_d = n_layers_d
        nf = num_feat
        self.model0 = nn.Sequential(
            nn.Conv2d(input_nc, nf, 4, stride=2, padding=2),
            nn.LeakyReLU(0.2))
        for n in range(1, n_layers_d):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers_d - 1 else 2
            setattr(self, f"model{n}", nn.Sequential(
                nn.Sequential(SNConv(nf_prev, nf, 4, stride=stride,
                                     padding=2, bias=False),
                              nn.InstanceNorm2d(nf)),
                nn.LeakyReLU(0.2)))
        setattr(self, f"model{n_layers_d}",
                nn.Sequential(nn.Conv2d(nf, 1, 4, padding=2)))

    def forward(self, x):
        results = []
        for n in range(self.n_layers_d + 1):
            x = getattr(self, f"model{n}")(x)
            results.append(x)
        return results


@ARCH_REGISTRY.register()
class HiFaceGANDiscriminator(nn.Module):
    """Multiscale PatchGAN (ref: hifacegan_arch.py:167-220): NHWC in, for
    each of ``num_d`` scales the list of its layers' NHWC features (the
    last, the logits, alone without ``keep_features``)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 conditional_d: bool = True, num_d: int = 2,
                 n_layers_d: int = 4, num_feat: int = 64,
                 norm_d: str = "spectralinstance",
                 keep_features: bool = True):
        super().__init__()
        input_nc = num_in_ch + (num_out_ch if conditional_d else 0)
        self.num_d, self.keep_features = num_d, keep_features
        for i in range(num_d):
            setattr(self, f"discriminator_{i}",
                    NLayerDiscriminator(input_nc, n_layers_d, num_feat))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        result = []
        for i in range(self.num_d):
            feats = getattr(self, f"discriminator_{i}")(x)
            feats = [f.permute(0, 2, 3, 1) for f in feats]
            result.append(feats if self.keep_features else feats[-1])
            x = avg_pool_valid(x)
        return result
