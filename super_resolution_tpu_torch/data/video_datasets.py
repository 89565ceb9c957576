"""Video SR datasets: REDS and Vimeo-90K training, folder-based testing
(port of super_resolution_tpu/data/video_datasets.py; ref:
basicsr/data/reds_dataset.py:14-320, vimeo90k_dataset.py:10-192,
video_test_dataset.py:12-284, data_util.py:11-115, 265-316).

Items are float32 RGB numpy arrays: 'lq' is (T, H, W, C), 'gt' is (H, W,
C) for the sliding-window networks or (T, H, W, C) for the recurrent ones.
Every random draw comes from the dataset's ``random.Random`` (reseeded
each epoch by the train loader) in the JAX package's order, so a seed gives
JAX's frames, crops and flips. Reads go through ``utils/file_client.py``
(disk or LMDB). ``FFHQDataset``, StyleGAN's GT-only face set, lives here
as in the JAX package.
"""

from __future__ import annotations

import glob
import random
from os import path as osp

import numpy as np

from super_resolution_tpu_torch.data.transforms import (augment, mod_crop,
                                                       paired_random_crop)
from super_resolution_tpu_torch.utils.file_client import FileClient
from super_resolution_tpu_torch.utils.flow_util import dequantize_flow
from super_resolution_tpu_torch.utils.img import (img2tensor, imfrombytes,
                                                  imread)
from super_resolution_tpu_torch.utils.misc import scandir
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY


# Edge-padding policies for sliding-window clips, vectorized over the raw
# (possibly out-of-range) index vector. Each maps (raw, center, last, half)
# -> substitute indices used where raw falls outside [0, last].
_EDGE_PAD_FNS = {
    "replicate": lambda raw, c, last, half: np.where(raw < 0, 0, last),
    "reflection": lambda raw, c, last, half: np.where(
        raw < 0, -raw, 2 * last - raw),
    "reflection_circle": lambda raw, c, last, half: np.where(
        raw < 0, c + half - raw, (c - half) - (raw - last)),
    "circle": lambda raw, c, last, half: np.where(
        raw < 0, raw + 2 * half + 1, raw - (2 * half + 1)),
}


def generate_frame_indices(crt_idx: int, max_frame_num: int, num_frames: int,
                           padding: str = "reflection"):
    """Sliding-window frame indices centered on crt_idx, with out-of-range
    positions substituted per the chosen edge policy (behavioral spec:
    ref data_util.py:43-93)."""
    if num_frames % 2 != 1:
        raise ValueError(f"window length must be odd, got {num_frames}")
    if padding not in _EDGE_PAD_FNS:
        raise ValueError(f"unknown edge-padding mode {padding!r}; choose "
                         f"from {sorted(_EDGE_PAD_FNS)}")
    half = num_frames // 2
    last = max_frame_num - 1
    raw = np.arange(crt_idx - half, crt_idx + half + 1)
    substitute = _EDGE_PAD_FNS[padding](raw, crt_idx, last, half)
    return [int(v) for v in np.where((raw >= 0) & (raw <= last), raw,
                                     substitute)]


def read_img_seq(path, require_mod_crop: bool = False, scale: int = 1,
                 return_imgname: bool = False):
    """Read a frame sequence -> (T, H, W, C) float32 RGB
    (ref: data_util.py:11-40)."""
    if isinstance(path, list):
        img_paths = path
    else:
        img_paths = sorted(scandir(path, full_path=True))
    imgs = [img2tensor(imread(p, float32=True)) for p in img_paths]
    if require_mod_crop:
        imgs = [mod_crop(img, scale) for img in imgs]
    imgs = np.stack(imgs, axis=0)
    if return_imgname:
        return imgs, [osp.splitext(osp.basename(p))[0] for p in img_paths]
    return imgs


def generate_gaussian_kernel(kernel_size: int = 13, sigma: float = 1.6):
    """Gaussian-smoothed dirac (ref: data_util.py:267-282)."""
    from scipy.ndimage import gaussian_filter

    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x, kernel_size: int = 13, scale: int = 4):
    """DUF's official Gaussian downsampling (ref: data_util.py:285-316):
    (T, H, W, C) float32 -> (T, H', W', C), reflect-padded, filtered and
    strided in one grouped convolution on the CPU."""
    if scale not in (2, 3, 4):
        raise ValueError(f"scale {scale} is not 2, 3 or 4")
    import torch
    import torch.nn.functional as F

    pad = kernel_size // 2 + scale * 2
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(
        0, 3, 1, 2)
    xp = F.pad(xt, (pad, pad, pad, pad), mode="reflect")
    c = xp.shape[1]
    kern = torch.from_numpy(generate_gaussian_kernel(
        kernel_size, 0.4 * scale).astype(np.float32))
    kern = kern.expand(c, 1, kernel_size, kernel_size)
    with torch.no_grad():
        out = F.conv2d(xp, kern, stride=scale, groups=c)
    return out[:, :, 2:-2, 2:-2].permute(0, 2, 3, 1).numpy()


class _VideoTrainBase:
    """Shared file-client plumbing for the training video datasets."""

    def __init__(self, opt):
        self.opt = opt
        self.io_backend_opt = dict(opt["io_backend"])
        self.is_lmdb = self.io_backend_opt.get("type") == "lmdb"
        self.file_client = None
        self._rng = random.Random()

    def seed(self, seed: int):
        self._rng = random.Random(seed)

    def _client(self):
        if self.file_client is None:
            opt = dict(self.io_backend_opt)
            self.file_client = FileClient(opt.pop("type"), **opt)
        return self.file_client

    def _read(self, path, key):
        return img2tensor(imfrombytes(self._client().get(path, key),
                                      float32=True))


@DATASET_REGISTRY.register()
class REDSDataset(_VideoTrainBase):
    """REDS sliding-window training dataset (ref: reds_dataset.py:14-205)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.flow_root = opt.get("dataroot_flow")
        assert opt["num_frame"] % 2 == 1
        self.num_frame = opt["num_frame"]
        self.num_half_frames = opt["num_frame"] // 2

        self.keys = []
        with open(opt["meta_info_file"], "r") as fin:
            for line in fin:
                folder, frame_num, _ = line.split(" ")
                self.keys.extend(f"{folder}/{i:08d}"
                                 for i in range(int(frame_num)))
        val_partition = self._val_partition()
        self.keys = [v for v in self.keys
                     if v.split("/")[0] not in val_partition]
        self.interval_list = opt.get("interval_list", [1])
        self.random_reverse = opt.get("random_reverse", False)

    def _val_partition(self):
        if self.opt["val_partition"] == "REDS4":
            return ["000", "011", "015", "020"]
        if self.opt["val_partition"] == "official":
            return [f"{v:03d}" for v in range(240, 270)]
        raise ValueError(f'Wrong validation partition '
                         f'{self.opt["val_partition"]}')

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        rng = self._rng
        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        key = self.keys[index]
        clip_name, frame_name = key.split("/")
        center_frame_idx = int(frame_name)

        interval = rng.choice(self.interval_list)
        start = center_frame_idx - self.num_half_frames * interval
        end = center_frame_idx + self.num_half_frames * interval
        while (start < 0) or (end > 99):
            center_frame_idx = rng.randint(0, 99)
            start = center_frame_idx - self.num_half_frames * interval
            end = center_frame_idx + self.num_half_frames * interval
        frame_name = f"{center_frame_idx:08d}"
        neighbor_list = list(range(start, end + 1, interval))
        if self.random_reverse and rng.random() < 0.5:
            neighbor_list.reverse()

        if self.is_lmdb:
            img_gt = self._read(f"{clip_name}/{frame_name}", "gt")
        else:
            img_gt = self._read(
                osp.join(self.gt_root, clip_name, f"{frame_name}.png"), "gt")
        img_lqs = []
        for neighbor in neighbor_list:
            if self.is_lmdb:
                img_lqs.append(self._read(f"{clip_name}/{neighbor:08d}", "lq"))
            else:
                img_lqs.append(self._read(
                    osp.join(self.lq_root, clip_name, f"{neighbor:08d}.png"),
                    "lq"))

        img_flows = None
        if self.flow_root is not None:
            img_flows = []
            for tag in ([f"_p{i}" for i in range(self.num_half_frames, 0, -1)]
                        + [f"_n{i}" for i in
                           range(1, self.num_half_frames + 1)]):
                if self.is_lmdb:
                    raw = self._client().get(f"{clip_name}/{frame_name}{tag}",
                                             "flow")
                else:
                    raw = self._client().get(
                        osp.join(self.flow_root, clip_name,
                                 f"{frame_name}{tag}.png"), "flow")
                cat_flow = imfrombytes(raw, flag="grayscale")
                dx, dy = np.split(cat_flow, 2, axis=0)
                img_flows.append(dequantize_flow(dx, dy, max_val=20,
                                                 denorm=False)
                                 .astype(np.float32))
            img_lqs.extend(img_flows)

        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs, gt_size, scale,
                                             rng=rng)
        if img_flows is not None:
            img_lqs, img_flows = (img_lqs[:self.num_frame],
                                  img_lqs[self.num_frame:])
        img_lqs.append(img_gt)
        if img_flows is not None:
            img_lqs, img_flows = augment(img_lqs, self.opt["use_hflip"],
                                         self.opt["use_rot"], img_flows,
                                         rng=rng)
        else:
            img_lqs = augment(img_lqs, self.opt["use_hflip"],
                              self.opt["use_rot"], rng=rng)

        out = {"lq": np.stack(img_lqs[:-1], 0), "gt": img_lqs[-1], "key": key}
        if img_flows is not None:
            img_flows.insert(self.num_half_frames,
                             np.zeros_like(img_flows[0]))
            out["flow"] = np.stack(img_flows, 0)
        return out


@DATASET_REGISTRY.register()
class REDSRecurrentDataset(_VideoTrainBase):
    """REDS clip dataset for recurrent nets (ref: reds_dataset.py:209-320)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.num_frame = opt["num_frame"]
        self.keys = []
        with open(opt["meta_info_file"], "r") as fin:
            for line in fin:
                folder, frame_num, _ = line.split(" ")
                self.keys.extend(f"{folder}/{i:08d}"
                                 for i in range(int(frame_num)))
        if self.opt["val_partition"] == "REDS4":
            val_partition = ["000", "011", "015", "020"]
        elif self.opt["val_partition"] == "official":
            val_partition = [f"{v:03d}" for v in range(240, 270)]
        else:
            raise ValueError(f'Wrong validation partition '
                             f'{self.opt["val_partition"]}')
        if opt.get("test_mode"):
            self.keys = [v for v in self.keys
                         if v.split("/")[0] in val_partition]
        else:
            self.keys = [v for v in self.keys
                         if v.split("/")[0] not in val_partition]
        self.interval_list = opt.get("interval_list", [1])
        self.random_reverse = opt.get("random_reverse", False)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        rng = self._rng
        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        key = self.keys[index]
        clip_name, frame_name = key.split("/")

        interval = rng.choice(self.interval_list)
        start = int(frame_name)
        if start > 100 - self.num_frame * interval:
            start = rng.randint(0, 100 - self.num_frame * interval)
        neighbor_list = list(range(start, start + self.num_frame * interval,
                                   interval))
        if self.random_reverse and rng.random() < 0.5:
            neighbor_list.reverse()

        img_lqs, img_gts = [], []
        for neighbor in neighbor_list:
            if self.is_lmdb:
                img_lqs.append(self._read(f"{clip_name}/{neighbor:08d}", "lq"))
                img_gts.append(self._read(f"{clip_name}/{neighbor:08d}", "gt"))
            else:
                img_lqs.append(self._read(
                    osp.join(self.lq_root, clip_name, f"{neighbor:08d}.png"),
                    "lq"))
                img_gts.append(self._read(
                    osp.join(self.gt_root, clip_name, f"{neighbor:08d}.png"),
                    "gt"))

        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs, gt_size,
                                              scale, rng=rng)
        imgs = augment(img_lqs + img_gts, self.opt["use_hflip"],
                       self.opt["use_rot"], rng=rng)
        t = len(imgs) // 2
        return {"lq": np.stack(imgs[:t], 0), "gt": np.stack(imgs[t:], 0),
                "key": key}


@DATASET_REGISTRY.register()
class Vimeo90KDataset(_VideoTrainBase):
    """Vimeo90K septuplet training dataset
    (ref: vimeo90k_dataset.py:10-134)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        with open(opt["meta_info_file"], "r") as fin:
            self.keys = [line.split(" ")[0] for line in fin]
        self.neighbor_list = [i + (9 - opt["num_frame"]) // 2
                              for i in range(opt["num_frame"])]
        self.random_reverse = opt.get("random_reverse", False)

    def __len__(self):
        return len(self.keys)

    def _paths(self, key, neighbor):
        clip, seq = key.split("/")
        if self.is_lmdb:
            return f"{clip}/{seq}/im{neighbor}", f"{clip}/{seq}/im{neighbor}"
        return (osp.join(self.lq_root, clip, seq, f"im{neighbor}.png"),
                osp.join(self.gt_root, clip, seq, f"im{neighbor}.png"))

    def __getitem__(self, index):
        rng = self._rng
        if self.random_reverse and rng.random() < 0.5:
            self.neighbor_list.reverse()
        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        key = self.keys[index]
        clip, seq = key.split("/")

        if self.is_lmdb:
            img_gt = self._read(f"{key}/im4", "gt")
        else:
            img_gt = self._read(osp.join(self.gt_root, clip, seq, "im4.png"),
                                "gt")
        img_lqs = [self._read(self._paths(key, n)[0], "lq")
                   for n in self.neighbor_list]

        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs, gt_size, scale,
                                             rng=rng)
        img_lqs.append(img_gt)
        img_results = augment(img_lqs, self.opt["use_hflip"],
                              self.opt["use_rot"], rng=rng)
        return {"lq": np.stack(img_results[:-1], 0), "gt": img_results[-1],
                "key": key}


@DATASET_REGISTRY.register()
class Vimeo90KRecurrentDataset(Vimeo90KDataset):
    """(ref: vimeo90k_dataset.py:137-192)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.flip_sequence = opt.get("flip_sequence", False)
        self.neighbor_list = [1, 2, 3, 4, 5, 6, 7]

    def __getitem__(self, index):
        rng = self._rng
        if self.random_reverse and rng.random() < 0.5:
            self.neighbor_list.reverse()
        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        key = self.keys[index]

        img_lqs, img_gts = [], []
        for n in self.neighbor_list:
            lq_path, gt_path = self._paths(key, n)
            img_lqs.append(self._read(lq_path, "lq"))
            img_gts.append(self._read(gt_path, "gt"))

        img_gts, img_lqs = paired_random_crop(img_gts, img_lqs, gt_size,
                                              scale, rng=rng)
        imgs = augment(img_lqs + img_gts, self.opt["use_hflip"],
                       self.opt["use_rot"], rng=rng)
        t = len(imgs) // 2
        img_lqs = np.stack(imgs[:t], 0)
        img_gts = np.stack(imgs[t:], 0)
        if self.flip_sequence:
            img_lqs = np.concatenate([img_lqs, img_lqs[::-1]], axis=0)
            img_gts = np.concatenate([img_gts, img_gts[::-1]], axis=0)
        return {"lq": img_lqs, "gt": img_gts, "key": key}


@DATASET_REGISTRY.register()
class VideoTestDataset:
    """Folder-based video test dataset (Vid4 / REDS4 / REDSofficial)
    (ref: video_test_dataset.py:12-130)."""

    def __init__(self, opt):
        self.opt = opt
        self.cache_data = opt["cache_data"]
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.data_info = {"lq_path": [], "gt_path": [], "folder": [],
                          "idx": [], "border": []}
        self.imgs_lq, self.imgs_gt = {}, {}
        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"], "r") as fin:
                subfolders = [line.split(" ")[0] for line in fin]
            subfolders_lq = [osp.join(self.lq_root, k) for k in subfolders]
            subfolders_gt = [osp.join(self.gt_root, k) for k in subfolders]
        else:
            subfolders_lq = sorted(glob.glob(osp.join(self.lq_root, "*")))
            subfolders_gt = sorted(glob.glob(osp.join(self.gt_root, "*")))

        for subfolder_lq, subfolder_gt in zip(subfolders_lq, subfolders_gt):
            subfolder_name = osp.basename(subfolder_lq)
            img_paths_lq = sorted(scandir(subfolder_lq, full_path=True))
            img_paths_gt = sorted(scandir(subfolder_gt, full_path=True))
            max_idx = len(img_paths_lq)
            assert max_idx == len(img_paths_gt)
            self.data_info["lq_path"].extend(img_paths_lq)
            self.data_info["gt_path"].extend(img_paths_gt)
            self.data_info["folder"].extend([subfolder_name] * max_idx)
            self.data_info["idx"].extend(f"{i}/{max_idx}"
                                         for i in range(max_idx))
            border_l = [0] * max_idx
            for i in range(self.opt["num_frame"] // 2):
                border_l[i] = 1
                border_l[max_idx - i - 1] = 1
            self.data_info["border"].extend(border_l)
            if self.cache_data:
                self.imgs_lq[subfolder_name] = read_img_seq(img_paths_lq)
                self.imgs_gt[subfolder_name] = read_img_seq(img_paths_gt)
            else:
                self.imgs_lq[subfolder_name] = img_paths_lq
                self.imgs_gt[subfolder_name] = img_paths_gt

    def __getitem__(self, index):
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        border = self.data_info["border"][index]
        lq_path = self.data_info["lq_path"][index]
        select_idx = generate_frame_indices(idx, max_idx,
                                            self.opt["num_frame"],
                                            padding=self.opt["padding"])
        if self.cache_data:
            imgs_lq = self.imgs_lq[folder][select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            imgs_lq = read_img_seq([self.imgs_lq[folder][i]
                                    for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]])[0]
        return {"lq": imgs_lq, "gt": img_gt, "folder": folder,
                "idx": self.data_info["idx"][index], "border": border,
                "lq_path": lq_path}

    def __len__(self):
        return len(self.data_info["gt_path"])


@DATASET_REGISTRY.register()
class VideoTestVimeo90KDataset:
    """(ref: video_test_dataset.py:133-198)."""

    def __init__(self, opt):
        self.opt = opt
        if opt["cache_data"]:
            raise NotImplementedError(
                "cache_data in Vimeo90K-Test dataset is not implemented.")
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.data_info = {"lq_path": [], "gt_path": [], "folder": [],
                          "idx": [], "border": []}
        neighbor_list = [i + (9 - opt["num_frame"]) // 2
                         for i in range(opt["num_frame"])]
        with open(opt["meta_info_file"], "r") as fin:
            subfolders = [line.split(" ")[0] for line in fin]
        for idx, subfolder in enumerate(subfolders):
            self.data_info["gt_path"].append(
                osp.join(self.gt_root, subfolder, "im4.png"))
            self.data_info["lq_path"].append(
                [osp.join(self.lq_root, subfolder, f"im{i}.png")
                 for i in neighbor_list])
            self.data_info["folder"].append("vimeo90k")
            self.data_info["idx"].append(f"{idx}/{len(subfolders)}")
            self.data_info["border"].append(0)

    def __getitem__(self, index):
        lq_path = self.data_info["lq_path"][index]
        imgs_lq = read_img_seq(lq_path)
        img_gt = read_img_seq([self.data_info["gt_path"][index]])[0]
        return {"lq": imgs_lq, "gt": img_gt,
                "folder": self.data_info["folder"][index],
                "idx": self.data_info["idx"][index],
                "border": self.data_info["border"][index],
                "lq_path": lq_path[self.opt["num_frame"] // 2]}

    def __len__(self):
        return len(self.data_info["gt_path"])


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):
    """(ref: video_test_dataset.py:202-249)."""

    def __getitem__(self, index):
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        border = self.data_info["border"][index]
        lq_path = self.data_info["lq_path"][index]
        select_idx = generate_frame_indices(idx, max_idx,
                                            self.opt["num_frame"],
                                            padding=self.opt["padding"])
        if self.cache_data:
            if self.opt["use_duf_downsampling"]:
                imgs_lq = duf_downsample(self.imgs_gt[folder][select_idx],
                                         kernel_size=13,
                                         scale=self.opt["scale"])
            else:
                imgs_lq = self.imgs_lq[folder][select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            if self.opt["use_duf_downsampling"]:
                imgs_lq = read_img_seq([self.imgs_gt[folder][i]
                                        for i in select_idx],
                                       require_mod_crop=True,
                                       scale=self.opt["scale"])
                imgs_lq = duf_downsample(imgs_lq, kernel_size=13,
                                         scale=self.opt["scale"])
            else:
                imgs_lq = read_img_seq([self.imgs_lq[folder][i]
                                        for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]],
                                  require_mod_crop=True,
                                  scale=self.opt["scale"])[0]
        return {"lq": imgs_lq, "gt": img_gt, "folder": folder,
                "idx": self.data_info["idx"][index], "border": border,
                "lq_path": lq_path}


@DATASET_REGISTRY.register()
class VideoRecurrentTestDataset(VideoTestDataset):
    """Whole-clip test dataset for recurrent models
    (ref: video_test_dataset.py:252-284)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.folders = sorted(set(self.data_info["folder"]))

    def __getitem__(self, index):
        folder = self.folders[index]
        if not self.cache_data:
            raise NotImplementedError(
                "Without cache_data is not implemented.")
        return {"lq": self.imgs_lq[folder], "gt": self.imgs_gt[folder],
                "folder": folder}

    def __len__(self):
        return len(self.folders)


@DATASET_REGISTRY.register()
class FFHQDataset:
    """FFHQ GT-only faces for StyleGAN training (ref:
    basicsr/data/ffhq_dataset.py:13-77): each item the image as float32 RGB
    (H, W, 3), flipped with ``use_hflip`` (the draw from the dataset's
    ``random.Random``), then (img - mean) / std. Paths: an LMDB's
    ``meta_info.txt`` keys; ``num_imgs`` names 00000000.png ... (70000
    where the folder does not exist); else the folder's files, sorted."""

    def __init__(self, opt):
        self.opt = opt
        self.io_backend_opt = dict(opt["io_backend"])
        self.gt_folder = opt["dataroot_gt"]
        self.mean = np.asarray(opt["mean"], np.float32)
        self.std = np.asarray(opt["std"], np.float32)
        self.file_client = None
        if self.io_backend_opt.get("type") == "lmdb":
            self.io_backend_opt["db_paths"] = self.gt_folder
            with open(osp.join(self.gt_folder, "meta_info.txt")) as fin:
                self.paths = [line.split(".")[0] for line in fin]
        elif opt.get("num_imgs") is not None or not osp.isdir(self.gt_folder):
            self.paths = [osp.join(self.gt_folder, f"{v:08d}.png")
                          for v in range(opt.get("num_imgs", 70000))]
        else:
            self.paths = sorted(scandir(self.gt_folder, full_path=True))
        self._rng = random.Random()

    def seed(self, seed: int):
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        if self.file_client is None:
            opt = dict(self.io_backend_opt)
            self.file_client = FileClient(opt.pop("type"), **opt)
        img_gt = img2tensor(imfrombytes(self.file_client.get(
            self.paths[index]), float32=True))
        img_gt = augment(img_gt, hflip=self.opt.get("use_hflip", True),
                         rotation=False, rng=self._rng)
        img_gt = (img_gt - self.mean) / self.std
        return {"gt": img_gt, "gt_path": self.paths[index]}
