"""The private PyTorch parts that the replica sweep relies on, in one place.

``torch.func`` gives a ``vmap`` rule no public way to tell a batched tensor
from a plain one, to put a replica's parameters into a module for the length
of one call of one of its methods, or to flatten a call's arguments. The
port takes each from torch's internals, here and nowhere else:

* :func:`is_batched`: ``torch._C._functorch.is_batchedtensor``;
* :func:`reparametrize`: ``torch.nn.utils.stateless._reparametrize_module``
  (what ``torch.func.functional_call`` runs inside);
* :func:`tree_flatten`, :func:`tree_unflatten`: ``torch.utils._pytree``.

They are known to work on torch 2.11 (the CUDA 12.8 build) and 2.13 (the
CPU build). ``tests/test_torch_port_func_internals.py`` checks each by its
name, so an upgrade of torch that moves or changes one fails there first.
"""

from __future__ import annotations

import torch
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["is_batched", "reparametrize", "tree_flatten", "tree_unflatten"]


def is_batched(x) -> bool:
    """Whether ``x`` is a tensor being mapped over by ``torch.func.vmap``."""
    return isinstance(x, torch.Tensor) and torch._C._functorch.is_batchedtensor(x)


def reparametrize(module: torch.nn.Module, params: dict):
    """A context in which ``module``'s parameters named in ``params`` are
    those tensors; the module's own come back on exit."""
    return _reparametrize_module(module, params)
