"""The PV-tree vote of the voting-parallel learner (kernels B16b, B16c).

Counterpart of the device work of the JAX package's
``parallel/voting_parallel.py`` ``vote_reduce`` (:126-148) around its
collectives:

- ``vote_gains`` (B16b; ``_local_feature_gains`` :55-84, the local
  ``lax.top_k`` :132 and the one-hot :133): from this rank's histogram
  [F, B, 3] each feature's best local split gain, with the constraints
  ``min_data_in_leaf`` and ``min_sum_hessian_in_leaf`` divided by the
  rank count (voting_parallel_tree_learner.cpp:61-63), then this rank's
  vote for its top ``k`` features and its gains with -inf as 0: the two
  [F] vectors the ranks all-reduce.  Under quantized training the int32
  histogram is read with the iteration's scales folded in, as B7c
  dequantizes it.
- ``vote_select`` (B16c): after the all-reduce, the top ``2k`` features
  by ``votes * 1e12 + gain_sum`` (ties to the lower index, as
  ``lax.top_k``) keep their histogram rows; every other feature's rows
  are zeroed in place, so the histogram all-reduce that follows sums only
  the selected features (a zero histogram never yields a valid split).

Both functions launch the kernels of ``csrc/vote.cu`` on CUDA tensors and
run their plain versions on CPU tensors; the plain versions sum the
prefix sums in bin order, as the kernel does, so the two agree bit for
bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .split import SplitParams


def vote_constants(params: SplitParams, n_shards: int):
    """(md, mh, l1, l2) of the local gain, as f32 values: the JAX
    package's ``max(min_data_in_leaf / S, 1) - 0.5`` and
    ``min_sum_hessian_in_leaf / S``."""
    md = np.float32(max(float(params.min_data_in_leaf) / n_shards, 1.0)
                    - 0.5)
    mh = np.float32(float(params.min_sum_hessian_in_leaf) / n_shards)
    return md, mh, np.float32(params.lambda_l1), \
        np.float32(params.lambda_l2)


def _check_hist(hist: torch.Tensor, scales: Optional[torch.Tensor]):
    if hist.dim() != 3 or hist.shape[2] != 3 \
            or hist.dtype not in (torch.float32, torch.int32):
        raise TypeError("hist must be an [F, B, 3] float32 or int32 tensor")
    if (hist.dtype == torch.int32) != (scales is not None):
        raise TypeError("an int32 histogram needs its scales, an f32 one "
                        "none")
    if scales is not None and (scales.shape != (3,)
                               or scales.dtype != torch.float32
                               or scales.device != hist.device):
        raise TypeError("scales must be a [3] float32 tensor on hist's "
                        "device")
    if hist.shape[1] > 1024:
        raise ValueError("the vote kernel takes at most 1024 bins")


def vote_gains(hist: torch.Tensor, params: SplitParams, n_shards: int,
               top_k: int, scales: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B16b: (votes, gains) [F] f32 of the local histogram ``hist`` [F, B,
    3] (f32, or int32 with ``scales`` [3]): ``votes`` 1 for the rank's
    top ``min(top_k, F)`` features by local gain, else 0; ``gains`` the
    local gains with the non-finite ones as 0 (module docstring)."""
    _check_hist(hist, scales)
    f, b, _ = hist.shape
    k = min(int(top_k), f)
    if k < 1:
        raise ValueError("top_k must be >= 1")
    if hist.device.type == "cpu":
        return vote_gains_plain(hist, params, n_shards, k, scales)
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    if not hist.is_contiguous():
        raise ValueError("vote_gains needs a contiguous histogram")
    md, mh, l1, l2 = vote_constants(params, n_shards)
    dev = hist.device
    gains = torch.empty(f, dtype=torch.float32, device=dev)
    votes = torch.empty(f, dtype=torch.float32, device=dev)
    finite = torch.empty(f, dtype=torch.float32, device=dev)
    err = _kernels.lib("vote").lgbt_vote_gains(
        hist.data_ptr(), None if scales is None else scales.data_ptr(), f,
        b, float(md), float(mh), float(l1), float(l2), k, gains.data_ptr(),
        votes.data_ptr(), finite.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.launched("vote_gains", err)
    return votes, finite


def local_feature_gains_plain(hist: torch.Tensor, params: SplitParams,
                              n_shards: int,
                              scales: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The [F] f32 best local gain of each feature (the JAX package's
    ``_local_feature_gains``), the prefix sums taken in bin order."""
    md, mh, l1, l2 = (torch.tensor(v, device=hist.device)
                      for v in vote_constants(params, n_shards))
    h = hist.to(torch.float32) * scales if scales is not None else hist
    f, b, _ = h.shape
    cum = torch.empty_like(h)
    acc = torch.zeros((f, 3), dtype=torch.float32, device=h.device)
    for j in range(b):
        acc = acc + h[:, j]
        cum[:, j] = acc
    total = cum[:, -1:, :]
    gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
    gr = total[..., 0] - gl
    hr = total[..., 1] - hl
    cr = total[..., 2] - cl

    def tl1(g):
        if not float(l1) > 0.0:
            return g
        return torch.sign(g) * torch.clamp_min(torch.abs(g) - l1, 0.0)

    eps = torch.tensor(np.float32(1e-10), device=h.device)
    a, c = tl1(gl), tl1(gr)
    gains = a * a / (hl + l2 + eps) + c * c / (hr + l2 + eps)
    valid = (cl >= md) & (cr >= md) & (hl >= mh) & (hr >= mh)
    gains = torch.where(valid, gains, torch.full((), float("-inf"),
                                                 device=h.device))
    return torch.amax(gains, dim=1)


def _top_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """The [F] bool mask of ``lax.top_k(x, k)``'s indices: the k largest,
    ties to the lower index."""
    order = torch.argsort(-x, stable=True)
    mask = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    mask[order[:k]] = True
    return mask


def vote_gains_plain(hist, params, n_shards, k, scales=None):
    """Plain PyTorch version of B16b."""
    gains = local_feature_gains_plain(hist, params, n_shards, scales)
    votes = _top_mask(gains, k).to(torch.float32)
    finite = torch.where(torch.isfinite(gains), gains,
                         torch.zeros((), device=gains.device))
    return votes, finite


def vote_score(votes: torch.Tensor, gain_sum: torch.Tensor) -> torch.Tensor:
    """``votes * 1e12 + gain_sum`` in f32, the global vote's order."""
    return votes * np.float32(1e12) + gain_sum


def vote_select(votes: torch.Tensor, gain_sum: torch.Tensor,
                hist: torch.Tensor, k2: int) -> torch.Tensor:
    """B16c: zero, in place, the histogram rows of every feature outside
    the top ``min(k2, F)`` by ``vote_score(votes, gain_sum)`` (all-reduced
    [F] f32 vectors); ``hist`` [F, B, 3] f32 or int32.  Returns
    ``hist``."""
    f = hist.shape[0]
    if hist.dim() != 3 or hist.shape[2] != 3 \
            or hist.dtype not in (torch.float32, torch.int32):
        raise TypeError("hist must be an [F, B, 3] float32 or int32 tensor")
    for name, t in (("votes", votes), ("gain_sum", gain_sum)):
        if t.shape != (f,) or t.dtype != torch.float32 \
                or t.device != hist.device:
            raise TypeError(f"{name} must be an [F] float32 tensor on "
                            "hist's device")
    k2 = min(int(k2), f)
    if k2 < 1:
        raise ValueError("k2 must be >= 1")
    if hist.device.type == "cpu":
        return vote_select_plain(votes, gain_sum, hist, k2)
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    if not all(t.is_contiguous() for t in (votes, gain_sum, hist)):
        raise ValueError("vote_select needs contiguous tensors")
    err = _kernels.lib("vote").lgbt_vote_select(
        votes.data_ptr(), gain_sum.data_ptr(), f, hist.shape[1], k2,
        hist.data_ptr(), int(hist.dtype == torch.int32),
        _kernels.stream_ptr(hist.device))
    _kernels.launched("vote_select", err)
    return hist


def vote_select_plain(votes, gain_sum, hist, k2: int) -> torch.Tensor:
    """Plain PyTorch version of B16c, in place on ``hist``."""
    keep = _top_mask(vote_score(votes, gain_sum), k2)
    hist.masked_fill_(~keep[:, None, None], 0)
    return hist
