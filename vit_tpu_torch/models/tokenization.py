"""Patch tokenizers (port of ``vit_tpu/models/tokenization.py``).

* ``SlidingWindowTokenizer`` — zero-pad to ``(num_patches-1)*stride+patch``,
  unfold, Linear; ``num_patches = ceil((L-P)/S)+1``.
* ``Conv1DPatchTokenizer`` — Conv1D(kernel=P, stride=S, VALID);
  ``num_patches = (L-P)//S + 1``. Run as unfold + product with the
  (H, 1, P) conv weight, so no cuDNN convolution (and no TF32) is involved.
* ``LinearPatchTokenizer`` — non-overlapping reshape, ``L % P == 0``.
* ``Patch2DTokenizer`` — images: Conv2D(P x P, stride P, VALID) over NHWC
  input (NCHW is transposed first, as in ``vit_tpu``), run as a patchify
  reshape + product with the (H, C, P, P) conv weight, tokens row-major over
  the patch grid.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.models.layers import Linear

__all__ = [
    "sliding_window_num_patches",
    "conv1d_num_patches",
    "unfold_1d",
    "SlidingWindowTokenizer",
    "Conv1DPatchTokenizer",
    "LinearPatchTokenizer",
    "Patch2DTokenizer",
]


def sliding_window_num_patches(length: int, patch: int, stride: int) -> int:
    return math.ceil((length - patch) / stride) + 1


def conv1d_num_patches(length: int, patch: int, stride: int) -> int:
    return (length - patch) // stride + 1


def unfold_1d(x: torch.Tensor, patch: int, stride: int, num_patches: int) -> torch.Tensor:
    """``(B, L) -> (B, num_patches, patch)`` sliding windows, zero-padded tail."""
    padded_len = (num_patches - 1) * stride + patch
    x = F.pad(x, (0, max(0, padded_len - x.shape[1])))
    return x.unfold(1, patch, stride)[:, :num_patches]


def _stride(stride: Optional[int], patch: int) -> int:
    return stride if (stride and stride > 0) else int(patch)


class _Tokenizer(nn.Module):
    def __init__(self, input_length: int, patch_size: int, hidden_size: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.input_length = input_length
        self.patch_size = patch_size
        self.dtype = dtype

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() != 2 or x.shape[1] != self.input_length:
            raise ValueError(
                f"{type(self).__name__} expects (batch, {self.input_length}), got {tuple(x.shape)}"
            )


class SlidingWindowTokenizer(_Tokenizer):
    """Unfold + Linear projection of overlapping 1-D windows."""

    def __init__(self, input_length: int, patch_size: int, hidden_size: int,
                 stride: Optional[int] = None, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(input_length, patch_size, hidden_size, dtype)
        self.stride_size = _stride(stride, patch_size)
        self.num_patches = sliding_window_num_patches(input_length, patch_size, self.stride_size)
        self.projection = Linear(patch_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        patches = unfold_1d(x, self.patch_size, self.stride_size, self.num_patches)
        return self.projection(patches, self.dtype)


class Conv1DPatchTokenizer(_Tokenizer):
    """Conv1D(kernel=P, stride=S, VALID) patch extraction; weight (H, 1, P)."""

    def __init__(self, input_length: int, patch_size: int, hidden_size: int,
                 stride: Optional[int] = None, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(input_length, patch_size, hidden_size, dtype)
        self.stride_size = _stride(stride, patch_size)
        self.num_patches = conv1d_num_patches(input_length, patch_size, self.stride_size)
        self.projection = Linear(
            patch_size, hidden_size, weight_shape=(hidden_size, 1, patch_size)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        patches = x.unfold(1, self.patch_size, self.stride_size)  # (B, T, P)
        return self.projection(patches, self.dtype)


class LinearPatchTokenizer(_Tokenizer):
    """Non-overlapping reshape tokenizer; requires ``L % P == 0``."""

    def __init__(self, input_length: int, patch_size: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32) -> None:
        if input_length % patch_size != 0:
            raise ValueError(
                f"input_length={input_length} must be divisible by patch_size={patch_size}"
            )
        super().__init__(input_length, patch_size, embed_dim, dtype)
        self.num_patches = input_length // patch_size
        self.projection = Linear(patch_size, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        patches = x.reshape(x.shape[0], self.num_patches, self.patch_size)
        return self.projection(patches, self.dtype)


class Patch2DTokenizer(nn.Module):
    """Standard ViT image patchify: ``(B, S, S, C) -> (B, (S/P)^2, H)``, the
    stride-P convolution's weight (H, C, P, P) as ``projection.weight``."""

    def __init__(self, image_size: int, patch_size: int, hidden_size: int,
                 num_channels: int = 3, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_channels = num_channels
        self.dtype = dtype
        self.num_patches = (image_size // patch_size) ** 2
        self.projection = Linear(num_channels * patch_size**2, hidden_size,
                                 weight_shape=(hidden_size, num_channels, patch_size, patch_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"Patch2DTokenizer expects 4-D input, got {tuple(x.shape)}")
        c = self.num_channels
        if x.shape[1] == c and x.shape[-1] != c:
            x = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        b, hgt, wid, _ = x.shape
        p = self.patch_size
        # VALID: rows and columns past the last whole patch are dropped.
        x = x[:, :hgt // p * p, :wid // p * p]
        patches = x.reshape(b, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 5, 2, 4)
        return self.projection(patches.reshape(b, -1, c * p * p), self.dtype)
