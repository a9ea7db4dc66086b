"""Spectral datasets (host-side numpy) and the data module (port of
``vit_tpu/data/datasets.py``, numpy as there, so the same files give the
same arrays bit for bit).

* path fallbacks: ``val_path``/``test_path`` default to ``file_path``;
  ``num_test_samples`` defaults to ``min(10000, num_samples)``;
* flux clipped at 0; NaN errors filled from the nearest column;
* per-spectrum SNR = ``||flux|| / ||error||``;
* classification labels = ``log_g > 2.5`` (binary);
* regression labels from ``data.param`` with label normalization
  ``standard|zscore|minmax`` fitted on train and propagated to val/test;
* val/test pre-generate noisy copies with the fixed seed 42; train noise is
  injected in the training step.

Besides HDF5 files, a data module can take its spectra from memory
(``SpecDataModule(config, source=...)``, a dict shaped like
``make_dummy_spectra``'s): every split then reads that source as it would
read ``file_path``, for machines without ``h5py``.

The masking helpers (:func:`fill_masked`, :func:`create_quantile_mask`,
:func:`create_lvrg_mask`) and :class:`SingleSpectrumNoiseDataset` are the
reference's library code that no main-path config uses, kept for the
spectral tools (:mod:`vit_tpu_torch.spectro`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from vit_tpu_torch.data.hdf5 import ERROR_KEY, load_spectra, read_params_table

__all__ = [
    "BaseSpecDataset",
    "ClassSpecDataset",
    "RegSpecDataset",
    "SingleSpectrumNoiseDataset",
    "SpecDataModule",
    "dataset_from_config",
    "parse_param_list",
    "fill_masked",
    "create_quantile_mask",
    "create_lvrg_mask",
]

VAL_TEST_NOISE_SEED = 42  # reference `dataloader/base.py:312` `_set_noise(seed=42)`


def parse_param_list(param: Union[str, Sequence[str], None]) -> List[str]:
    """``'T_eff, log_g'`` | ``['T_eff','log_g']`` -> ``['T_eff','log_g']``."""
    if param is None:
        return []
    if isinstance(param, str):
        return [p.strip() for p in param.split(",") if p.strip()]
    return [str(p) for p in param]


def _slice_source(source: Dict[str, Any], n: Optional[int]) -> Dict[str, np.ndarray]:
    """``load_spectra``'s output from an in-memory source."""
    n = None if (n is None or n == -1) else int(n)
    out = {"wave": np.asarray(source["wave"], np.float32),
           "flux": np.asarray(source["flux"][:n], np.float32)}
    if source.get("error") is not None:
        out["error"] = np.asarray(source["error"][:n], np.float32)
    return out


def _fill_nan_with_nearest(arr: np.ndarray) -> np.ndarray:
    """Fill NaNs at the spectral edges from the adjacent column (reference
    `dataloader/base.py:212-217`), then any interior NaNs with the median."""
    arr = arr.copy()
    if np.isnan(arr[:, 0]).any():
        arr[:, 0] = arr[:, 1]
    if np.isnan(arr[:, -1]).any():
        arr[:, -1] = arr[:, -2]
    if np.isnan(arr).any():
        arr = np.where(np.isnan(arr), np.nanmedian(arr), arr)
    return arr


def fill_masked(arr: np.ndarray, mask: np.ndarray, filler: Optional[float] = None) -> np.ndarray:
    """``filler=None`` selects the masked columns; else fills the complement."""
    mask = np.asarray(mask, bool)
    if filler is None:
        return arr[..., mask]
    out = arr.copy()
    out[..., ~mask] = filler
    return out


def create_quantile_mask(arr: np.ndarray, ratio: float = 0.9) -> np.ndarray:
    """Mask pixels whose per-pixel median flux is below the given quantile."""
    median = np.median(arr, axis=0)
    return median < np.quantile(median, ratio)


def create_lvrg_mask(wave: np.ndarray, line_positions, halfwidth: int = 25) -> np.ndarray:
    """+-``halfwidth`` pixels around each line position."""
    wave = np.asarray(wave)
    mask = np.zeros(len(wave), dtype=bool)
    for wdx in np.digitize(np.asarray(line_positions), wave):
        mask[max(0, wdx - halfwidth) : min(wdx + halfwidth, len(wave))] = True
    return mask


class SingleSpectrumNoiseDataset:
    """One spectrum repeated with ``repeat`` noise draws made up front from
    ``np.random.default_rng(seed)``, so a seed gives ``vit_tpu``'s arrays."""

    def __init__(self, flux_0: np.ndarray, error_0: np.ndarray, noise_level: float = 1.0,
                 repeat: int = 1000, seed: int = 42) -> None:
        self.repeat = int(repeat)
        self.noise_level = float(noise_level)
        self.flux_0 = np.asarray(flux_0, np.float32)
        self.error_0 = np.asarray(error_0, np.float32)
        rng = np.random.default_rng(seed)
        noise = rng.standard_normal((self.repeat, len(self.flux_0))).astype(np.float32)
        self.noisy = self.flux_0 + noise * self.error_0 * self.noise_level

    def __len__(self) -> int:
        return self.repeat

    def __getitem__(self, idx: int):
        return self.noisy[idx], self.flux_0, self.error_0

    def arrays(self) -> Dict[str, np.ndarray]:
        n = self.repeat
        return {
            "x": self.noisy,
            "flux": np.broadcast_to(self.flux_0, (n, len(self.flux_0))),
            "error": np.broadcast_to(self.error_0, (n, len(self.error_0))),
        }


class BaseSpecDataset:
    """Spectra + errors + stellar parameters, loaded fully into host memory."""

    def __init__(
        self,
        file_path: Optional[str] = None,
        val_path: Optional[str] = None,
        test_path: Optional[str] = None,
        num_samples: Optional[int] = None,
        num_test_samples: Optional[int] = None,
        param: Union[str, Sequence[str], None] = None,
        label_norm: Optional[str] = None,
        noise_level: float = 0.0,
        noise_max: Optional[float] = None,
        source: Optional[Dict[str, Any]] = None,
        **_: Any,
    ) -> None:
        self.file_path = file_path
        self.val_path = val_path if val_path is not None else file_path
        self.test_path = test_path if test_path is not None else file_path
        self.num_samples = int(num_samples) if num_samples is not None else 1
        self.num_test_samples = (
            int(num_test_samples)
            if num_test_samples is not None
            else min(10000, self.num_samples)
        )
        self.param = param
        self.label_norm = (
            (label_norm or "none").lower() if isinstance(label_norm, str) else "none"
        )
        self.noise_level = float(noise_level or 0.0)
        self.noise_max = noise_max
        self.source = source  # in-memory {wave, flux, error, params}, read as file_path

        self.wave: Optional[np.ndarray] = None
        self.flux: Optional[np.ndarray] = None
        self.error: Optional[np.ndarray] = None
        self.noisy: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None
        self.snr: Optional[np.ndarray] = None
        self.params_table: Optional[Dict[str, np.ndarray]] = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_config(cls, config: dict, source: Optional[Dict[str, Any]] = None
                    ) -> "BaseSpecDataset":
        """Build from the ``data`` + ``noise`` config sections (the
        reference's ``Configurable`` mixin maps sections to ctor kwargs)."""
        kwargs = dict(config.get("data", {}) or {}, source=source)
        noise = config.get("noise", {}) or {}
        kwargs.setdefault("noise_level", noise.get("noise_level", 0.0))
        kwargs.setdefault("noise_max", noise.get("noise_max"))
        return cls(**kwargs)

    # -- loading -----------------------------------------------------------
    def get_path_and_samples(self, stage: Optional[str]):
        if stage in {"fit", "train", None}:
            return self.file_path, self.num_samples
        path = self.test_path if stage == "test" else self.val_path
        return path, self.num_test_samples

    def load_data(self, stage: Optional[str] = None) -> None:
        path, n = self.get_path_and_samples(stage)
        if self.source is not None:
            path = "<in-memory source>"
            spec = _slice_source(self.source, n)
        elif path is None:
            raise FileNotFoundError(f"[{stage or 'train'}] no data path configured")
        else:
            spec = load_spectra(path, n)
        self.wave = spec["wave"]
        self.flux = np.clip(spec["flux"], 0.0, None)
        error = spec.get("error")
        if error is None:
            # Reference parity: a missing error dataset is a malformed file
            # and raises (`dataloader/base.py:232` KeyError). Zero-filling
            # silently disabled noise augmentation (x + randn*0*level) and
            # produced ~1e12 SNRs while claiming noisy evaluation.
            raise KeyError(
                f"{path} has no '{ERROR_KEY}' dataset (required by the "
                "reference HDF5 schema)"
            )
        if np.isnan(error).any():
            error = _fill_nan_with_nearest(error)
        self.error = error
        self.n_loaded = self.flux.shape[0]
        self.num_pixels = self.flux.shape[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            self.snr = np.linalg.norm(self.flux, axis=-1) / np.maximum(
                np.linalg.norm(self.error, axis=-1), 1e-12
            )
        self._load_labels(stage, path, self.n_loaded)
        if stage in ("val", "test", "validate"):
            self._set_noise()

    def _load_labels(self, stage: Optional[str], path: str, n: int) -> None:
        raise NotImplementedError

    def _load_params_table(self, path: str, n: int) -> Dict[str, np.ndarray]:
        if self.source is not None:
            self.params_table = {k: np.asarray(v)[:n] for k, v in self.source["params"].items()}
        else:
            self.params_table = read_params_table(path, n)
        return self.params_table

    def _set_noise(self, seed: int = VAL_TEST_NOISE_SEED) -> None:
        """Pre-generate fixed-seed noisy copies for reproducible eval."""
        if self.noise_level > 0:
            rng = np.random.default_rng(seed)
            noise = rng.standard_normal(self.flux.shape).astype(np.float32)
            self.noisy = self.flux + noise * self.error * self.noise_level
        else:
            self.noisy = None

    # -- access ------------------------------------------------------------
    def __len__(self) -> int:
        return 0 if self.flux is None else int(self.flux.shape[0])

    @property
    def model_input(self) -> np.ndarray:
        """What the model sees: pre-noised copies for val/test, flux for train."""
        return self.noisy if self.noisy is not None else self.flux

    def arrays(self) -> Dict[str, np.ndarray]:
        """Column-oriented batch source consumed by the Batcher."""
        out = {"x": self.model_input, "flux": self.flux, "error": self.error}
        if self.labels is not None:
            out["label"] = self.labels
        return out


class ClassSpecDataset(BaseSpecDataset):
    """Binary classification of surface gravity: label = ``log_g > 2.5``."""

    num_classes = 2

    def _load_labels(self, stage, path, n) -> None:
        table = self._load_params_table(path, n)
        if "log_g" not in table:
            raise KeyError(f"'log_g' not found in parameter table of {path}")
        self.labels = (np.asarray(table["log_g"]) > 2.5).astype(np.int32)


class RegSpecDataset(BaseSpecDataset):
    """Regression of stellar parameters listed in ``data.param``."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.label_mean: Optional[np.ndarray] = None
        self.label_std: Optional[np.ndarray] = None
        self.label_min: Optional[np.ndarray] = None
        self.label_max: Optional[np.ndarray] = None

    @property
    def param_names(self) -> List[str]:
        return parse_param_list(self.param)

    def _load_labels(self, stage, path, n) -> None:
        names = self.param_names
        if not names:
            raise ValueError(
                "Regression requires 'data.param' in the config "
                "(string, comma-separated string, or list)."
            )
        table = self._load_params_table(path, n)
        cols = []
        for p in names:
            if p not in table:
                raise KeyError(
                    f"Requested param '{p}' not found in HDF columns: {sorted(table)}"
                )
            cols.append(np.asarray(table[p], dtype=np.float32))
        self.labels = np.stack(cols, axis=-1)  # (N, num_labels)
        self._maybe_normalize_labels(stage)

    def _maybe_normalize_labels(self, stage: Optional[str], eps: float = 1e-8) -> None:
        kind = self.label_norm
        if kind not in ("standard", "zscore", "minmax"):
            return
        is_train = stage in (None, "fit", "train")
        if kind in ("standard", "zscore"):
            if is_train or self.label_mean is None or self.label_std is None:
                self.label_mean = self.labels.mean(axis=0)
                self.label_std = self.labels.std(axis=0)  # population std (ddof=0)
            std = np.where(np.abs(self.label_std) < eps, 1.0, self.label_std)
            self.labels = (self.labels - self.label_mean) / std
        else:  # minmax
            if is_train or self.label_min is None or self.label_max is None:
                self.label_min = self.labels.min(axis=0)
                self.label_max = self.labels.max(axis=0)
            denom = self.label_max - self.label_min
            denom = np.where(np.abs(denom) < eps, 1.0, denom)
            self.labels = (self.labels - self.label_min) / denom

    def norm_stats(self) -> Dict[str, Optional[np.ndarray]]:
        return {
            "label_mean": self.label_mean,
            "label_std": self.label_std,
            "label_min": self.label_min,
            "label_max": self.label_max,
        }

    def set_norm_stats(self, stats: Dict[str, Optional[np.ndarray]]) -> None:
        """Install train-fitted stats before ``load_data`` on val/test
        (reference propagation at `reference src/vit.py:44-51`)."""
        for k, v in stats.items():
            setattr(self, k, v)

    def denormalize(self, y: np.ndarray) -> np.ndarray:
        """Inverse of the label normalization (used by eval reports).

        Delegates to the one shared implementation
        (:func:`vit_tpu_torch.viz.viz_utils.denormalize`, also used by serving).
        """
        from vit_tpu_torch.viz.viz_utils import denormalize

        return denormalize(y, self.label_norm, **self.norm_stats())


def _normalize_task(config: dict, task_type: Optional[str] = None) -> str:
    """Shared task normalization (vit_tpu_torch.config.normalize_task) —
    dataset selection MUST agree with the model builder's head/loss choice."""
    from vit_tpu_torch.config import normalize_task

    return normalize_task(config, task_type)


def dataset_from_config(config: dict, task_type: Optional[str] = None,
                        source: Optional[Dict[str, Any]] = None) -> BaseSpecDataset:
    """Pick the dataset class by ``model.task_type`` (reference `vit.py:30-42`)."""
    cls = ClassSpecDataset if _normalize_task(config, task_type) == "cls" else RegSpecDataset
    return cls.from_config(config, source=source)


class SpecDataModule:
    """Train/val/test dataset container with label-stat propagation.

    Equivalent of the reference's ``ViTDataModule``
    (`reference src/basemodule.py:28-112`, `reference src/vit.py:30-51`)
    without the Lightning inversion of control: ``setup('fit')`` loads
    train+val, ``setup('test')`` loads test; regression label-norm statistics
    fitted on train are propagated into val/test before their labels load.
    """

    def __init__(self, config: dict, source: Optional[Dict[str, Any]] = None) -> None:
        self.config = config
        self.source = source
        self.task_type = _normalize_task(config)
        self.batch_size = int((config.get("train", {}) or {}).get("batch_size", 64))
        self.train: Optional[BaseSpecDataset] = None
        self.val: Optional[BaseSpecDataset] = None
        self.test: Optional[BaseSpecDataset] = None

    @classmethod
    def from_config(cls, config: dict) -> "SpecDataModule":
        return cls(config)

    def _new_dataset(self) -> BaseSpecDataset:
        return dataset_from_config(self.config, self.task_type, self.source)

    def _propagate_stats(self, dst: BaseSpecDataset) -> None:
        if isinstance(self.train, RegSpecDataset) and isinstance(dst, RegSpecDataset):
            dst.set_norm_stats(self.train.norm_stats())

    def setup(self, stage: str = "fit") -> None:
        if stage in ("fit", "train"):
            if self.train is None:
                self.train = self._new_dataset()
                self.train.load_data("fit")
            # Reference parity: setup('fit') ALWAYS builds a val split —
            # data.val_path falls back to file_path in the dataset
            # (`basemodule.py:60-66`, `dataloader/base.py:76`). Only the
            # plateau scheduler requires an *explicit* val_path (loop.py).
            data_cfg = self.config.get("data", {}) or {}
            if self.val is None and (data_cfg.get("val_path") or data_cfg.get("file_path")
                                     or self.source is not None):
                self.val = self._new_dataset()
                self._propagate_stats(self.val)
                self.val.load_data("val")
        elif stage == "test":
            norm = str(
                (self.config.get("data", {}) or {}).get("label_norm") or "none"
            ).lower()
            if (
                self.train is None
                and self.task_type != "cls"
                and norm in ("standard", "zscore", "minmax")
            ):
                # Train-fitted label-norm stats must be propagated to the
                # test split (reference `vit.py:44-51`). With label_norm
                # 'none' this would load the full training split (GBs of
                # flux) just to copy four Nones — skip it.
                self.train = self._new_dataset()
                self.train.load_data("fit")
            if self.test is None:
                self.test = self._new_dataset()
                self._propagate_stats(self.test)
                self.test.load_data("test")
        else:
            raise ValueError(f"Unknown stage: {stage}")

    @property
    def val_batch_size(self) -> int:
        """Reference clamps val batch to dataset size (`basemodule.py:87-104`)."""
        if self.val is None or len(self.val) == 0:
            return self.batch_size
        return min(self.batch_size, len(self.val))
