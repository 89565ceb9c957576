"""Dataset factory and the evaluation loader (port of the val / test half
of super_resolution_tpu/data/__init__.py; ref: basicsr/data/__init__.py).

The loader is a plain sequential batch-1 iterator, not a
``torch.utils.data.DataLoader`` with workers, so that the order and the
arrays are the JAX package's exactly. The training loader is not ported."""

from __future__ import annotations

from copy import deepcopy

import numpy as np

from super_resolution_tpu_torch.data import paired_dataset  # noqa: F401
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY


def build_dataset(dataset_opt: dict):
    dataset_opt = deepcopy(dataset_opt)
    return DATASET_REGISTRY.get(dataset_opt["type"])(dataset_opt)


class EvalLoader:
    """Sequential batch-1 loader (val/test, ref: data/__init__.py:84-94)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield _collate([self.dataset[i]])


def _collate(items: list) -> dict:
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def build_dataloader(dataset, dataset_opt: dict):
    """The loader of a val or test set."""
    if dataset_opt["phase"] == "train":
        raise NotImplementedError(
            f"{dataset_opt.get('name')}: the training loader is not ported "
            f"(ROADMAP.md queue 1, training)")
    return EvalLoader(dataset)
