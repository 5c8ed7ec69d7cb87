"""Quantized training (kernels B7a-c): the int8/int16 packing of the per-row
(grad*w, hess*w, w) stack and the dequantization of integer histograms.

Counterpart of the JAX package's ``ops/quantize.py`` (``QuantSpec``,
``_fmix32``, ``counter_uniform``, ``quant_scales``, ``quantize_stack``) and
``ops/split.py`` ``dequantize_hist``.  Once a tree the grower takes one
shared scale a channel over all rows, ``max|v| / qmax`` (B7a), and packs
the stack into int8 or int16 (B7b): ``floor(v / s + u)`` with ``u`` in
[0, 1) from a counter hash of (global row id, channel, iteration, seed)
(stochastic rounding), or ``round(v / s)`` half to even (``nearest``).  A
zero stays zero under both.  The histogram passes (B1/B1-K's integer form,
``ops/histogram.py``) then sum exact int32 histograms, the grower keeps
and subtracts them as integers, and each child's histogram is dequantized
(B7c, ``float(h) * s[c]``) just before the EFB expansion (B9) or the split
scan (B2).

Each function has its plain PyTorch version beside it: the CPU tests run
it, and the kernel (``csrc/quantize.cu``) equals it bit for bit.  The
plain hash works in int64 masked to 32 bits (torch has no uint32
multiply); the kernel's f32 arithmetic is one IEEE operation at a time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels

_M32 = 0xFFFFFFFF
# the least scale: an all-zero channel dequantizes to exact zeros
SCALE_FLOOR = 1e-30
# B7a's row blocks and threads (csrc/quantize.cu kMaxBlocks, kThreads)
_SCALE_BLOCKS, _SCALE_THREADS = 264, 256


class QuantSpec(NamedTuple):
    """Quantized-training configuration (the JAX package's ``QuantSpec``):
    ``bits`` 8 (int8 lanes) or 16 (int16), ``stochastic`` rounding (else
    nearest), and the ``seed`` folded into every iteration's key."""
    bits: int = 8
    stochastic: bool = True
    seed: int = 0

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def dtype(self) -> torch.dtype:
        return torch.int8 if self.bits == 8 else torch.int16


def max_rows(spec: QuantSpec) -> int:
    """The most rows whose int32 histograms cannot overflow: one bin may
    collect every row, each adding at most ``qmax`` a channel."""
    return (2 ** 31 - 1) // spec.qmax


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` of int64 tensors holding uint32 values, in two
    16-bit halves of ``c`` so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64 (the JAX
    package's ``_fmix32``)."""
    x = x & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def seed_mul(seed: int) -> int:
    """``seed * 2654435761 mod 2^32``, the seed's share of the key."""
    return (int(seed) & _M32) * 2654435761 & _M32


def counter_uniform(row_id: torch.Tensor, n_chan: int, iter_key: int,
                    seed: int) -> torch.Tensor:
    """[N, n_chan] f32 in [0, 1) keyed by (global row id, channel,
    iteration, seed): the top 24 bits of a hash, so the f32 value is exact
    and below 1 (the JAX package's ``counter_uniform``)."""
    k = int(fmix32(torch.tensor([(int(iter_key) & _M32) ^ seed_mul(seed)],
                                dtype=torch.int64))[0])
    rows = row_id.to(torch.int64) & _M32
    chan = torch.arange(n_chan, dtype=torch.int64, device=row_id.device)
    h = fmix32(_mul32(rows, 0x9E3779B9)[:, None]
               ^ _mul32(chan, 0x85EBCA6B)[None, :] ^ k)
    return (h >> 8).to(torch.float32) * np.float32(2.0 ** -24)


def quant_scales_plain(vals: torch.Tensor, qmax: int) -> torch.Tensor:
    """Plain PyTorch version of B7a: [C] f32 ``max(max|v|, 1e-30) /
    qmax``."""
    m = vals.abs().amax(dim=0)
    floor = torch.tensor(SCALE_FLOOR, dtype=torch.float32, device=m.device)
    return torch.maximum(m, floor) / np.float32(int(qmax))


def quantize_stack_plain(vals: torch.Tensor, scales: torch.Tensor,
                         spec: QuantSpec, iter_key: int = 0,
                         row_offset: int = 0,
                         seed: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of B7b: [N, C] f32 -> [N, C] int8/int16 under
    the shared ``scales``; ``row_offset`` is the first row's global id and
    ``seed`` overrides ``spec.seed``."""
    x = vals / scales[None, :]
    if spec.stochastic:
        rows = (torch.arange(vals.shape[0], dtype=torch.int64,
                             device=vals.device) + int(row_offset))
        # the row id in int32, as the JAX package forms it
        rows = rows.to(torch.int32)
        u = counter_uniform(rows, vals.shape[1], iter_key,
                            spec.seed if seed is None else seed)
        q = torch.floor(x + u)
    else:
        q = torch.round(x)
    return q.clamp(-spec.qmax, spec.qmax).to(spec.dtype)


def dequantize_hist_plain(hist: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B7c: ``float(hist) * scales`` over the
    trailing channel axis."""
    return hist.to(torch.float32) * scales


def _on(t: torch.Tensor, *others) -> str:
    dev = t.device
    if any(o is not None and o.device != dev for o in others):
        raise ValueError("quantize inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_vals(vals: torch.Tensor) -> None:
    if vals.dim() != 2 or vals.shape[1] != 3 or vals.dtype != torch.float32:
        raise TypeError("vals must be a [N, 3] float32 tensor")
    if vals.shape[0] < 1:
        raise ValueError("quantized training needs at least one row")


def quant_scales(vals: torch.Tensor, qmax: int, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7a: the [3] f32 shared scales of ``vals`` [N, 3] for ``qmax``.
    ``out``: the [3] tensor to write into.  CUDA tensors launch the kernel
    of ``csrc/quantize.cu``, CPU tensors run ``quant_scales_plain``."""
    _check_vals(vals)
    if out is not None and (out.shape != (3,) or out.dtype != torch.float32):
        raise TypeError("out must be a [3] float32 tensor")
    if _on(vals, out) == "cpu":
        res = quant_scales_plain(vals, qmax)
        return res if out is None else out.copy_(res)
    if not vals.is_contiguous() or (out is not None
                                    and not out.is_contiguous()):
        raise ValueError("quant_scales needs contiguous tensors")
    n = vals.shape[0]
    if out is None:
        out = torch.empty(3, dtype=torch.float32, device=vals.device)
    blocks = min(-(-n // _SCALE_THREADS), _SCALE_BLOCKS)
    partial = torch.empty((blocks, 3), dtype=torch.float32,
                          device=vals.device)
    err = _kernels.lib("quantize").lgbt_quant_scales(
        vals.data_ptr(), n, float(int(qmax)), partial.data_ptr(),
        out.data_ptr(), _kernels.stream_ptr(vals.device))
    _kernels.launched("quant_scales", err)
    return out


def quantize_stack(vals: torch.Tensor, scales: torch.Tensor,
                   spec: QuantSpec, rng_iter: Optional[torch.Tensor] = None,
                   *, out: Optional[torch.Tensor] = None,
                   row_offset: int = 0) -> torch.Tensor:
    """B7b: ``vals`` [N, 3] f32 packed to ``spec.dtype`` under ``scales``
    [3], keyed by ``rng_iter`` (a [1] int32 device tensor, the trainer's
    device iteration; None is iteration 0, as the JAX grower's default
    key); the rows' global ids are ``row_offset`` .. ``row_offset`` + N -
    1 (0 when one device holds every row; a data-parallel rank's first
    global row otherwise).  ``out``: the [N, 3] tensor to write into.
    CUDA tensors launch the kernel of ``csrc/quantize.cu``, CPU tensors
    run ``quantize_stack_plain``."""
    _check_vals(vals)
    if scales.shape != (3,) or scales.dtype != torch.float32:
        raise TypeError("scales must be a [3] float32 tensor")
    it = rng_iter
    if it is not None and (it.shape != (1,) or it.dtype != torch.int32):
        raise TypeError("rng_iter must be a [1] int32 tensor")
    if out is not None and (out.shape != vals.shape
                            or out.dtype != spec.dtype):
        raise TypeError(f"out must be a [N, 3] {spec.dtype} tensor")
    if _on(vals, scales, it, out) == "cpu":
        key = 0 if it is None else int(it[0])
        res = quantize_stack_plain(vals, scales, spec, key,
                                   row_offset=row_offset)
        return res if out is None else out.copy_(res)
    if not all(t.is_contiguous() for t in (vals, scales)) or (
            out is not None and not out.is_contiguous()):
        raise ValueError("quantize_stack needs contiguous tensors")
    if out is None:
        out = torch.empty(vals.shape, dtype=spec.dtype, device=vals.device)
    err = _kernels.lib("quantize").lgbt_quantize_stack(
        vals.data_ptr(), scales.data_ptr(), vals.shape[0],
        None if it is None else it.data_ptr(), seed_mul(spec.seed),
        int(bool(spec.stochastic)), int(spec.bits), int(row_offset),
        out.data_ptr(),
        _kernels.stream_ptr(vals.device))
    _kernels.launched("quantize_stack", err)
    return out


def dequantize_hist(hist: torch.Tensor, scales: torch.Tensor, *,
                    active: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7c: the int32 histogram ``hist`` [..., 3] as f32, ``float(h) *
    scales[c]``.  ``active`` (a [1] int32 device tensor, the grower's step
    flag): where it is 0 nothing is written (``out``, if given, keeps its
    values; a new result is unspecified).  CUDA tensors launch the kernel
    of ``csrc/quantize.cu``, CPU tensors run ``dequantize_hist_plain``."""
    if hist.dtype != torch.int32 or hist.dim() < 1 or hist.shape[-1] != 3:
        raise TypeError("hist must be an int32 tensor of 3 channels")
    if scales.shape != (3,) or scales.dtype != torch.float32:
        raise TypeError("scales must be a [3] float32 tensor")
    if active is not None and (active.shape != (1,)
                               or active.dtype != torch.int32):
        raise TypeError("active must be a [1] int32 tensor")
    if out is not None and (out.shape != hist.shape
                            or out.dtype != torch.float32):
        raise TypeError("out must be a float32 tensor of hist's shape")
    if _on(hist, scales, active, out) == "cpu":
        if active is not None and not bool(active[0]):
            return out if out is not None else torch.zeros(hist.shape)
        res = dequantize_hist_plain(hist, scales)
        return res if out is None else out.copy_(res)
    if not all(t.is_contiguous() for t in (hist, scales)) or (
            out is not None and not out.is_contiguous()):
        raise ValueError("dequantize_hist needs contiguous tensors")
    if out is None:
        out = torch.empty(hist.shape, dtype=torch.float32,
                          device=hist.device)
    err = _kernels.lib("quantize").lgbt_dequant_hist(
        hist.data_ptr(), scales.data_ptr(), hist.numel(),
        None if active is None else active.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(hist.device))
    _kernels.launched("dequant_hist", err)
    return out
