"""Image datasets for the 2-D ViT family (port of ``vit_tpu/data/images.py``).

The ViT-S/16, B/16 and L/16 configs under ``configs/exp/image/`` read local
``.npz`` files (``images`` uint8 NHWC + ``labels`` int, the CIFAR-10 numpy
export); with no path configured, each stage falls back to a deterministic
synthetic class-conditional set (:func:`make_dummy_images`, learnable by
construction), and a configured path that is missing raises. Images are
scaled to [0, 1] and normalised with the CIFAR-10 channel statistics.

Same module contract as :class:`vit_tpu_torch.data.datasets.SpecDataModule`:
``setup(stage)`` and ``arrays()`` feeding the Batcher, the fused epoch and
the vmapped sweep. numpy only, as in ``vit_tpu``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = ["ImageDataset", "ImageDataModule", "make_dummy_images", "write_dummy_images_npz"]

# Channel statistics used for normalization (CIFAR-10 convention).
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def make_dummy_images(
    n: int = 256,
    image_size: int = 32,
    num_classes: int = 10,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Synthetic class-conditional images: per-class color + blob position.

    Learnable by construction (class determines the dominant channel and a
    bright square's location), for tests and data-free runs; the same draws
    as ``vit_tpu``'s for the same arguments.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    images = rng.integers(0, 64, size=(n, image_size, image_size, 3))
    for i, c in enumerate(labels):
        ch = c % 3
        images[i, :, :, ch] += 64 + 8 * (c // 3)
        # class-positioned bright patch
        pos = (c * image_size // num_classes) % max(1, image_size - 8)
        images[i, pos : pos + 8, pos : pos + 8, :] += 96
    return {
        "images": np.clip(images, 0, 255).astype(np.uint8),
        "labels": labels.astype(np.int32),
    }


def write_dummy_images_npz(path: str, **kwargs) -> str:
    data = make_dummy_images(**kwargs)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **data)
    return path


class ImageDataset:
    """NHWC uint8 images + integer labels, normalized on access."""

    def __init__(
        self,
        file_path: Optional[str] = None,
        num_samples: Optional[int] = None,
        num_test_samples: Optional[int] = None,
        val_path: Optional[str] = None,
        test_path: Optional[str] = None,
        image_size: int = 32,
        num_classes: int = 10,
        normalize: bool = True,
        **_,
    ) -> None:
        self.file_path = file_path
        self.val_path = val_path or file_path
        self.test_path = test_path or file_path
        self.num_samples = int(num_samples) if num_samples else -1
        self.num_test_samples = int(num_test_samples) if num_test_samples else -1
        self.image_size = int(image_size)
        self.num_classes = int(num_classes)
        self.normalize = normalize
        self.images: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None

    @classmethod
    def from_config(cls, config: dict) -> "ImageDataset":
        d = dict(config.get("data", {}) or {})
        m = config.get("model", {}) or {}
        d.setdefault("image_size", m.get("image_size", 32))
        d.setdefault("num_classes", m.get("num_labels", 10))
        return cls(**d)

    def load_data(self, stage: Optional[str] = None) -> None:
        if stage in ("fit", "train", None):
            path, n = self.file_path, self.num_samples
        else:
            path = self.test_path if stage == "test" else self.val_path
            n = self.num_test_samples
        if path and not os.path.exists(path):
            # A configured path that is missing is an error, as for spectra:
            # a typo must not train on synthetic images.
            raise FileNotFoundError(f"Image data file not found: {path}")
        if path:
            with np.load(path) as z:
                images, labels = z["images"], z["labels"]
        else:
            # no path configured: deterministic synthetic set per stage
            seed = {"fit": 0, "train": 0, None: 0, "val": 1, "validate": 1, "test": 2}.get(stage, 0)
            count = n if n and n > 0 else 256
            d = make_dummy_images(count, self.image_size, self.num_classes, seed=seed)
            images, labels = d["images"], d["labels"]
        if n and n > 0:
            images, labels = images[:n], labels[:n]
        x = images.astype(np.float32) / 255.0
        if self.normalize:
            x = (x - CIFAR_MEAN) / CIFAR_STD
        self.images = x
        self.labels = labels.astype(np.int32)

    def __len__(self) -> int:
        return 0 if self.images is None else len(self.images)

    @property
    def model_input(self) -> np.ndarray:
        """What the model consumes (the spectra datasets' interface)."""
        return self.images

    def arrays(self) -> Dict[str, np.ndarray]:
        return {"x": self.images, "label": self.labels}


class ImageDataModule:
    """Train/val/test image datasets (SpecDataModule-compatible surface)."""

    def __init__(self, config: dict) -> None:
        self.config = config
        self.batch_size = int((config.get("train", {}) or {}).get("batch_size", 64))
        self.train: Optional[ImageDataset] = None
        self.val: Optional[ImageDataset] = None
        self.test: Optional[ImageDataset] = None

    @classmethod
    def from_config(cls, config: dict) -> "ImageDataModule":
        return cls(config)

    def setup(self, stage: str = "fit") -> None:
        if stage in ("fit", "train"):
            if self.train is None:
                self.train = ImageDataset.from_config(self.config)
                self.train.load_data("fit")
            if self.val is None:
                self.val = ImageDataset.from_config(self.config)
                self.val.load_data("val")
        elif stage == "test":
            if self.test is None:
                self.test = ImageDataset.from_config(self.config)
                self.test.load_data("test")
        else:
            raise ValueError(f"Unknown stage: {stage}")

    @property
    def val_batch_size(self) -> int:
        if self.val is None or len(self.val) == 0:
            return self.batch_size
        return min(self.batch_size, len(self.val))
