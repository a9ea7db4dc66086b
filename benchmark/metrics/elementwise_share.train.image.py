"""elementwise_share.train.image: the share of the traced epoch's kernel time in
torch's own kernels (``at::native::``: elementwise passes such as the hash
dropout's int64 arithmetic and GELU, reductions, softmax, LayerNorm,
indexing, the optimizer's multi-tensor kernels), beside the library
products and the port's CUDA kernels. Moves train_samples_per_s.image.
"""

from benchlib import readers


def read(trace, d, params):
    return readers.share_of_kernels(trace, readers.TORCH_NATIVE)
