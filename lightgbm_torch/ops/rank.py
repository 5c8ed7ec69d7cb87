"""The ranking gradients (kernels B13a and B13b).

Counterparts of the JAX package's ``objectives.py``
``LambdarankNDCG._bucket_gradients`` (:515) and
``RankXENDCG._bucket_gradients`` (:597), with the sum over buckets and the
hessian's floor ``max(hess, 1e-9)`` of their ``get_gradients``.  Queries
are given by their boundaries, an int32 tensor [Q+1] on the scores'
device; rows are in query order.

On a CUDA tensor each function launches its hand-written kernel of
``csrc/rank.cu`` (one block a query, no padding; see that file), counts
the launch, and raises ``KernelError`` if the launch fails: there is no
fallback.  On a CPU tensor it runs its plain PyTorch version, a direct
transcription of the JAX function over queries padded into chunks of
similar size (the pairwise [Qc, M, M] tensors of a chunk kept under
``_PLAIN_ELEMS`` elements), which is the CPU path and the kernels'
oracle, never fast.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from .. import _kernels
from .random import MASK32, bits_to_unit, threefry2x32

# elements of one chunk's pairwise tensor in the plain versions
_PLAIN_ELEMS = 1 << 22
_NEG = -1e30


def _check(score, label, boundaries) -> None:
    n = score.shape[0] if score.dim() == 1 else -1
    for name, t in (("score", score), ("label", label)):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.float32:
            raise TypeError(f"{name} must be an [N] float32 tensor")
    if boundaries.dim() != 1 or boundaries.dtype != torch.int32 \
            or boundaries.shape[0] < 1:
        raise TypeError("boundaries must be a [Q+1] int32 tensor")
    if label.device != score.device or boundaries.device != score.device:
        raise ValueError("score, label and boundaries must be on one device")


def _contiguous(*ts) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the ranking kernels need contiguous tensors")


def lambdarank_grad(score: torch.Tensor, label: torch.Tensor,
                    boundaries: torch.Tensor, label_gain: torch.Tensor,
                    inverse_max_dcg: torch.Tensor, *, trunc: int,
                    norm: bool, sigmoid: float, with_ranks: bool = False):
    """B13a: the [N] f32 LambdaRank-NDCG gradients and hessians of
    ``score`` (``label`` indexes ``label_gain``, clamped to it;
    ``inverse_max_dcg`` [Q] f32 per query), hessians floored at 1e-9.
    With ``with_ranks`` also each row's [N] int32 rank in its query
    (descending score, ties by index)."""
    _check(score, label, boundaries)
    q = boundaries.shape[0] - 1
    for name, t, shape in (("label_gain", label_gain, None),
                           ("inverse_max_dcg", inverse_max_dcg, (q,))):
        if t.dim() != 1 or t.dtype != torch.float32 \
                or (shape is not None and tuple(t.shape) != shape) \
                or t.device != score.device:
            raise TypeError(f"{name} must be a float32 vector on the "
                            "scores' device")
    kw = dict(trunc=int(trunc), norm=bool(norm), sigmoid=float(sigmoid))
    if score.device.type == "cpu":
        return lambdarank_grad_plain(score, label, boundaries, label_gain,
                                     inverse_max_dcg, with_ranks=with_ranks,
                                     **kw)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    _contiguous(score, label, boundaries, label_gain, inverse_max_dcg)
    n = score.shape[0]
    g = torch.empty_like(score)
    h = torch.empty_like(score)
    rank = torch.empty(n, dtype=torch.int32, device=score.device)
    if q > 0:
        sig = np.float32(sigmoid)
        err = _kernels.lib("rank").lgbt_lambdarank(
            score.data_ptr(), label.data_ptr(), boundaries.data_ptr(),
            label_gain.data_ptr(), label_gain.shape[0],
            inverse_max_dcg.data_ptr(), q, int(trunc), int(bool(norm)),
            float(sig), float(np.float32(float(sigmoid) * float(sigmoid))),
            rank.data_ptr(), g.data_ptr(), h.data_ptr(),
            _kernels.stream_ptr(score.device))
        _kernels.launched("lambdarank", err)
    return (g, h, rank) if with_ranks else (g, h)


def xendcg_grad(score: torch.Tensor, label: torch.Tensor,
                boundaries: torch.Tensor, key: Tuple[int, int], *,
                with_gamma: bool = False):
    """B13b: the [N] f32 XE-NDCG gradients and hessians of ``score`` under
    the iteration key ``key`` (two uint32 ints: ``fold_in(PRNGKey(seed),
    it)``), hessians floored at 1e-9.  With ``with_gamma`` also each
    row's [N] f32 draw gamma."""
    _check(score, label, boundaries)
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    if score.device.type == "cpu":
        return xendcg_grad_plain(score, label, boundaries, (k0, k1),
                                 with_gamma=with_gamma)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    _contiguous(score, label, boundaries)
    q = boundaries.shape[0] - 1
    g = torch.empty_like(score)
    h = torch.empty_like(score)
    gamma = torch.empty_like(score) if with_gamma else None
    if q > 0:
        err = _kernels.lib("rank").lgbt_xendcg(
            score.data_ptr(), label.data_ptr(), boundaries.data_ptr(), q, k0,
            k1, g.data_ptr(), h.data_ptr(),
            None if gamma is None else gamma.data_ptr(),
            _kernels.stream_ptr(score.device))
        _kernels.launched("xendcg", err)
    return (g, h, gamma) if with_gamma else (g, h)


# --- the plain versions ------------------------------------------------------

def _chunks(boundaries: torch.Tensor, pairwise: bool
            ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """(query ids [Qc], row index [Qc, M], mask [Qc, M], M) of queries in
    ascending size, each chunk padded to its largest query, with Qc * M
    (or Qc * M^2 when ``pairwise``) kept under ``_PLAIN_ELEMS`` where a
    query allows it."""
    b = boundaries.cpu().numpy().astype(np.int64)
    sizes = np.diff(b)
    order = np.argsort(sizes, kind="stable")
    order = order[sizes[order] > 0]
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order):
            m = int(sizes[order[j]])
            if (j + 1 - i) * (m * m if pairwise else m) > _PLAIN_ELEMS:
                break
            j += 1
        qids = order[i:j]
        m = int(sizes[qids[-1]])
        pos = np.arange(m)
        mask = pos[None, :] < sizes[qids][:, None]
        idx = np.where(mask, b[qids][:, None] + pos[None, :], 0)
        yield qids, idx, mask, m
        i = j


def lambdarank_grad_plain(score, label, boundaries, label_gain,
                          inverse_max_dcg, *, trunc: int, norm: bool,
                          sigmoid: float, with_ranks: bool = False):
    """Plain PyTorch version of B13a: ``LambdarankNDCG._bucket_gradients``
    over chunks of queries, then ``max(hess, 1e-9)``."""
    dev = score.device
    g = torch.zeros_like(score)
    h = torch.zeros_like(score)
    rank = torch.zeros(score.shape[0], dtype=torch.int32, device=dev)
    ng = label_gain.shape[0]
    sig = float(sigmoid)
    for qids, idx_np, mask_np, m in _chunks(boundaries, pairwise=True):
        idx = torch.as_tensor(idx_np, device=dev)
        qmask = torch.as_tensor(mask_np, device=dev)
        inv = inverse_max_dcg[torch.as_tensor(qids, device=dev)]
        s = score[idx]
        y = label[idx].to(torch.int32).to(torch.int64).clamp(0, ng - 1)
        s_masked = torch.where(qmask, s, torch.full_like(s, _NEG))
        order = torch.argsort(-s_masked, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1)
        gains = label_gain[y]
        discount = 1.0 / torch.log2(2.0 + ranks.to(torch.float32))
        in_trunc = ranks < trunc
        si, sj = s[:, :, None], s[:, None, :]
        gi, gj = gains[:, :, None], gains[:, None, :]
        di, dj = discount[:, :, None], discount[:, None, :]
        valid = qmask[:, :, None] & qmask[:, None, :]
        valid &= (gi > gj) & (in_trunc[:, :, None] | in_trunc[:, None, :])
        delta = torch.abs((gi - gj) * (di - dj)) * inv[:, None, None]
        sdiff = torch.clamp(sig * (si - sj), -50.0, 50.0)
        p = 1.0 / (1.0 + torch.exp(sdiff))
        lam = sig * p * delta
        hcoef = sig * sig * p * (1.0 - p) * delta
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        lam = torch.where(valid, lam, zero)
        hcoef = torch.where(valid, hcoef, zero)
        grad_q = -lam.sum(dim=2) + lam.sum(dim=1)
        hess_q = hcoef.sum(dim=2) + hcoef.sum(dim=1)
        if norm:
            tot = torch.abs(lam).sum(dim=(1, 2)) + 1e-9
            scale = torch.where(tot > 0, torch.log2(1.0 + tot) / tot,
                                torch.ones_like(tot))
            grad_q = grad_q * scale[:, None]
            hess_q = hess_q * scale[:, None]
        rows = idx[qmask]
        g[rows] = grad_q[qmask]
        h[rows] = hess_q[qmask]
        rank[rows] = ranks[qmask].to(torch.int32)
    h = torch.clamp(h, min=1e-9)
    return (g, h, rank) if with_ranks else (g, h)


def query_gamma(key: Tuple[int, int], qids: torch.Tensor,
                m: int) -> torch.Tensor:
    """[len(qids), m] f32 draws: row r is ``uniform(fold_in(key,
    qids[r]), m)`` of ``jax.random`` (the partitionable stream, so word p
    does not depend on m)."""
    z = torch.zeros_like(qids)
    kq0, kq1 = threefry2x32(key, z, qids & MASK32)
    p = torch.arange(int(m), dtype=torch.int64, device=qids.device)[None, :]
    o0, o1 = threefry2x32((kq0[:, None], kq1[:, None]), p >> 32, p & MASK32)
    return bits_to_unit(o0 ^ o1)


def _softmax_rows(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(x - torch.amax(x, dim=1, keepdim=True))
    return e / torch.sum(e, dim=1, keepdim=True)


def xendcg_grad_plain(score, label, boundaries, key: Tuple[int, int], *,
                      with_gamma: bool = False):
    """Plain PyTorch version of B13b: ``RankXENDCG._bucket_gradients`` over
    chunks of queries, then ``max(hess, 1e-9)``."""
    dev = score.device
    g = torch.zeros_like(score)
    h = torch.zeros_like(score)
    gamma_rows = torch.zeros_like(score)
    for qids, idx_np, mask_np, m in _chunks(boundaries, pairwise=False):
        idx = torch.as_tensor(idx_np, device=dev)
        qmask = torch.as_tensor(mask_np, device=dev)
        fmask = qmask.to(torch.float32)
        s = torch.where(qmask, score[idx], torch.full_like(fmask, _NEG))
        y = label[idx]
        gamma = query_gamma(key, torch.as_tensor(qids.astype(np.int64),
                                                 device=dev), m)
        phi = (torch.exp2(y) - gamma) * fmask
        target = phi / torch.clamp(phi.sum(dim=1, keepdim=True), min=1e-9)
        rho = _softmax_rows(s) * fmask
        grad_q = (rho - target) * fmask
        hess_q = torch.clamp(rho * (1.0 - rho), min=1e-9) * fmask
        rows = idx[qmask]
        g[rows] = grad_q[qmask]
        h[rows] = hess_q[qmask]
        gamma_rows[rows] = gamma[qmask]
    h = torch.clamp(h, min=1e-9)
    return (g, h, gamma_rows) if with_gamma else (g, h)


def valid_pairs(score: torch.Tensor, label: torch.Tensor,
                boundaries: torch.Tensor, label_gain: torch.Tensor,
                trunc: int) -> int:
    """The pairs B13a's function needs on these inputs (gain_i > gain_j
    and either rank within ``trunc``): the work its bound counts."""
    total = 0
    ng = label_gain.shape[0]
    for _, idx_np, mask_np, _m in _chunks(boundaries, pairwise=True):
        idx = torch.as_tensor(idx_np, device=score.device)
        qmask = torch.as_tensor(mask_np, device=score.device)
        s = torch.where(qmask, score[idx], torch.full_like(score[idx], _NEG))
        ranks = torch.argsort(torch.argsort(-s, dim=1, stable=True), dim=1)
        gains = label_gain[label[idx].to(torch.int32).to(torch.int64)
                           .clamp(0, ng - 1)]
        tr = ranks < trunc
        v = qmask[:, :, None] & qmask[:, None, :] \
            & (gains[:, :, None] > gains[:, None, :]) \
            & (tr[:, :, None] | tr[:, None, :])
        total += int(v.sum())
    return total
