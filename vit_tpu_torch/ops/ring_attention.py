"""Ring attention: exact attention with the sequence split over a mesh axis
(port of ``vit_tpu/ops/ring_attention.py``).

Each rank of the ``axis`` group holds ``T/N`` of the queries, keys and
values. Its queries' attention is accumulated in an online softmax while
the K/V shards travel around the ring (``dist.batch_isend_irecv`` to the
next rank, from the previous one; ``vit_tpu``'s ``ppermute``), and each
shard is itself walked in key blocks of ``block_k`` columns, so the
``(B, H, T/N, T/N)`` scores never exist at once::

    for step in range(N):                 # the ring (K/V rotate)
        for blk in key blocks of the shard:
            s      = q @ k_blk^T * scale
            m_new  = max(m, rowmax(s));  p = exp(s - m_new)
            acc    = acc * exp(m - m_new) + p @ v_blk
            l      = l * exp(m - m_new) + rowsum(p)
        k, v = the previous rank's k, v   # not after the last step

The blocks are ``torch.einsum`` products in fp32, as ``vit_tpu``'s are
``jnp.einsum`` products with fp32 results: the ring runs no CUDA kernel of
its own. The backward is ``vit_tpu``'s hand-written one (:179-262): the
forward keeps only ``(q, k, v, o, lse)``, and a second ring pass carries
each shard's dK and dV accumulators with it, re-deriving each probability
block from the saved logsumexp; after N rotations they are home.

Dropout on the probabilities uses :func:`~vit_tpu_torch.ops.dropout.
hash_keep_mask` at the block's global coordinates ``(b_off, 0, q_off,
col0)``: the rank's first batch row, the shard's first query, the block's
first key. So a split run draws the mask of the unsplit ``(B, H, T, T)``
probabilities for the same seed, which is the mask the ``xla`` route's
``hash_dropout`` draws (not the flash kernels' ``_hash_bits``), bit for bit
as ``vit_tpu``'s ring draws it. The mask multiplies the numerator only; the
normaliser sums the unmasked probabilities.

:func:`ring_attention` takes this rank's batch rows of q, k, v over the
whole sequence, keeps its shard (:func:`~vit_tpu_torch.parallel.comm.
scatter`), runs the ring and gathers the output's shards, so the layers
around it run on whole sequences as elsewhere.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_tpu_torch.ops.dropout import current_batch_offset, device_seed, hash_keep_mask
from vit_tpu_torch.parallel import comm

__all__ = ["ring_attention"]

# Default inner key-block width (vit_tpu's).
_DEFAULT_BLOCK_K = 512


def _pick_block(block_k: Optional[int], t_local: int) -> int:
    """Largest divisor of ``t_local`` that is <= the requested block."""
    want = t_local if block_k is None else max(1, min(int(block_k), t_local))
    while t_local % want:
        want -= 1
    return want


def _split_blocks(x: torch.Tensor, nb: int, bk: int) -> torch.Tensor:
    """(B, H, Tl, d) -> (nb, B, H, bk, d)."""
    b, h, _, d = x.shape
    return x.reshape(b, h, nb, bk, d).movedim(2, 0)


def _merge_blocks(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_split_blocks`: (nb, B, H, bk, d) -> (B, H, Tl, d)."""
    nb, b, h, bk, d = y.shape
    return y.movedim(0, 2).reshape(b, h, nb * bk, d)


def _offsets(pos: int, b_off: int, t_local: int):
    """Global (batch, query-row) offsets of this rank's block."""
    return b_off, pos * t_local


class _Ring:
    """The ring's geometry on this rank: ``ranks`` the axis group's global
    ranks in ring order, ``pos`` this rank's place among them."""

    def __init__(self, group, ranks, pos: int, b_off: int, scale: float, rate: float,
                 block_k: int) -> None:
        self.group, self.ranks, self.pos, self.n = group, list(ranks), pos, len(ranks)
        self.b_off, self.scale, self.rate, self.block_k = b_off, scale, rate, block_k

    def rotate(self, *xs: torch.Tensor):
        """Each tensor to the next rank; the previous rank's in return."""
        if self.n == 1:
            return xs
        nxt = self.ranks[(self.pos + 1) % self.n]
        prv = self.ranks[(self.pos - 1) % self.n]
        out = [torch.empty_like(x) for x in xs]
        comm.exchange([(x, nxt) for x in xs], [(o, prv) for o in out], self.group)
        return out

    def mask(self, shape, seed, b_off: int, q_off: int, col0: int, device) -> torch.Tensor:
        return hash_keep_mask(shape, self.rate, seed, offsets=(b_off, 0, q_off, col0),
                              device=device)


def _ring_fwd(q, k, v, seed, ring: _Ring):
    t_local = q.shape[2]
    bk = _pick_block(ring.block_k, t_local)
    nb = t_local // bk
    b_off, q_off = _offsets(ring.pos, ring.b_off, t_local)
    qs = q.float() * ring.scale
    acc = torch.zeros_like(qs)
    m = torch.full_like(qs[..., :1], -torch.inf)
    l = torch.zeros_like(qs[..., :1])
    k_cur, v_cur = k, v
    for step in range(ring.n):
        # At rotation `step` this rank holds the shard that started on
        # rank (pos - step) mod n.
        k_off = ((ring.pos - step) % ring.n) * t_local
        for j, (k_blk, v_blk) in enumerate(zip(_split_blocks(k_cur, nb, bk),
                                               _split_blocks(v_cur, nb, bk))):
            s = torch.einsum("bhqd,bhkd->bhqk", qs, k_blk.float())
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)  # the unmasked probabilities
            if ring.rate > 0.0:
                p = p * ring.mask(p.shape, seed, b_off, q_off, k_off + j * bk, q.device)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.float())
            m = m_new
        if step < ring.n - 1:  # the last shard is not rotated on
            k_cur, v_cur = ring.rotate(k_cur, v_cur)
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), m + torch.log(l)


def _ring_bwd(q, k, v, seed, o, lse, g, ring: _Ring):
    t_local = q.shape[2]
    bk = _pick_block(ring.block_k, t_local)
    nb = t_local // bk
    b_off, q_off = _offsets(ring.pos, ring.b_off, t_local)
    qs = q.float() * ring.scale
    do = g.float()
    delta = (do * o.float()).sum(dim=-1, keepdim=True)  # flash's D (holds under the mask)
    dq = torch.zeros_like(qs)
    k_cur, v_cur = k, v
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_cur = torch.zeros_like(dk_cur)
    for step in range(ring.n):
        k_off = ((ring.pos - step) % ring.n) * t_local
        dk_blocks, dv_blocks = [], []
        for j, (k_blk, v_blk) in enumerate(zip(_split_blocks(k_cur, nb, bk),
                                               _split_blocks(v_cur, nb, bk))):
            kf = k_blk.float()
            s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
            p = torch.exp(s - lse)  # from the saved logsumexp
            dp = torch.einsum("bhqd,bhkd->bhqk", do, v_blk.float())
            p_acc = p
            if ring.rate > 0.0:
                mask = ring.mask(p.shape, seed, b_off, q_off, k_off + j * bk, q.device)
                p_acc, dp = p * mask, dp * mask
            dv_blocks.append(torch.einsum("bhqk,bhqd->bhkd", p_acc, do))
            ds = p * (dp - delta)
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kf) * ring.scale
            dk_blocks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qs))  # qs holds the scale
        dk_cur = dk_cur + _merge_blocks(torch.stack(dk_blocks))
        dv_cur = dv_cur + _merge_blocks(torch.stack(dv_blocks))
        # dK/dV travel with their shards: after n rotations they are home.
        k_cur, v_cur, dk_cur, dv_cur = ring.rotate(k_cur, v_cur, dk_cur, dv_cur)
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _RingCore(torch.autograd.Function):
    """The ring's forward and hand-written backward on this rank's shards
    (B, H, T/N, d); keeps (q, k, v, o, lse), O(T/N·d) a rank."""

    @staticmethod
    def forward(ctx, q, k, v, seed, ring):
        o, lse = _ring_fwd(q, k, v, seed, ring)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.seed, ctx.ring = seed, ring
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, ctx.seed, o, lse, g.contiguous(), ctx.ring)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "data", batch_axis: Optional[str] = None,
                   dropout_rate: float = 0.0, dropout_seed=None,
                   block_k: Optional[int] = None) -> torch.Tensor:
    """Exact softmax attention with the sequence split over ``mesh``'s
    ``axis``; scale ``d**-0.5``.

    ``q, k, v``: this rank's (B, H, T, d) over the whole sequence, ``T``
    divisible by the axis size; returns the whole (B, H, T, d) output.
    ``batch_axis``: the mesh axis this rank's B rows are a block of (its
    rows are global rows ``coord * B`` on, for the dropout mask); without
    it they start at the :func:`~vit_tpu_torch.ops.dropout.batch_offset` in
    force.
    ``dropout_rate``/``dropout_seed`` (an int32, int or 0-d tensor): in-ring
    dropout on the probabilities. ``block_k``: the inner key-block width
    (default min(512, T/N), rounded down to a divisor of T/N).
    """
    b, _, t, d = q.shape
    n = mesh.size(axis)
    if t % n != 0:
        raise ValueError(
            f"sequence length {t} must be divisible by the '{axis}' axis size {n}"
        )
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    seed = None
    if rate > 0.0:
        seed = dropout_seed if isinstance(dropout_seed, int) else device_seed(dropout_seed,
                                                                              q.device)
    bk = _pick_block(block_k if block_k is not None else _DEFAULT_BLOCK_K, t // n)
    b_off = mesh.coord(batch_axis) * b if batch_axis else current_batch_offset()
    group = mesh.group(axis)
    ring = _Ring(group, mesh.group_ranks(axis), mesh.coord(axis), b_off, d**-0.5, rate, bk)
    local = [comm.scatter(x, group, 2) for x in (q, k, v)]
    o = _RingCore.apply(*local, seed, ring)
    return comm.gather(o, group, 2)
