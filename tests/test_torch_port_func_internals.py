"""The private PyTorch parts behind the port's replica sweep
(``vit_tpu_torch.func_internals``), each checked by name, so that a torch
upgrade that moves or changes one fails here rather than deep in a sweep."""

import torch

from vit_tpu_torch import func_internals as fi


def test_is_batched_tells_vmapped_tensors_apart():
    x = torch.arange(6.0).view(2, 3)
    seen = []
    torch.func.vmap(lambda r: seen.append(fi.is_batched(r)) or r)(x)
    assert seen == [True]
    assert not fi.is_batched(x) and not fi.is_batched(3) and not fi.is_batched(None)


def test_reparametrize_swaps_parameters_for_one_call():
    lin = torch.nn.Linear(3, 2)
    own = lin.weight
    w, b = torch.ones(2, 3), torch.zeros(2)
    x = torch.arange(3.0)
    with fi.reparametrize(lin, {"weight": w, "bias": b}):
        assert lin.weight is w
        assert torch.equal(lin(x), torch.full((2,), 3.0))
    assert lin.weight is own and isinstance(lin.weight, torch.nn.Parameter)


def test_tree_flatten_round_trips_and_counts_leaves():
    t = torch.zeros(2)
    tree = [t, (1, {"a": t, "b": "s"}), [2.0]]
    leaves, spec = fi.tree_flatten(tree)
    assert spec.num_leaves == len(leaves) == 5
    assert leaves[0] is t and leaves[2] is t
    back = fi.tree_unflatten(leaves, spec)
    assert back[1][1]["a"] is t and back[1][1]["b"] == "s" and back[2] == [2.0]
