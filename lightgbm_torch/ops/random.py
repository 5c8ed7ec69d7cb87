"""The threefry2x32 counter-based random stream of ``jax.random``.

The JAX package draws its bagging masks with ``jax.random`` (``models/
gbdt.py`` ``_bagging_w``: ``uniform(fold_in(PRNGKey(bagging_seed),
epoch), (N,))``).  The port has no JAX, so this module computes the same
bits in plain PyTorch integer arithmetic (uint32 words carried in int64
tensors and masked), and ``csrc/sample.cu`` computes them on the card.
The variant is JAX's default:

- ``prng_key(seed)`` is ``threefry_seed`` on a 32-bit seed (JAX without
  ``jax_enable_x64``, the JAX package's setting): the words
  ``(seed >> 32, seed & 0xffffffff)`` of the seed converted to int32,
  so the high word is 0 and the low word is the seed modulo 2^32;
- ``fold_in(key, data)`` is ``threefry2x32(key, (0, uint32(data)))``;
- ``uniform(key, n)`` follows ``jax_threefry_partitionable=True`` (the
  default from JAX 0.5): ``bits[i] = o1 ^ o2`` of
  ``threefry2x32(key, (i >> 32, i & 0xffffffff))``, then
  ``bitcast((bits >> 9) | 0x3f800000) - 1.0`` as f32.

threefry2x32 is 20 rounds with the standard rotation constants and key
schedule (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3").
``tests/test_torch_random.py`` pins every function to ``jax.random``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import _kernels

MASK32 = 0xFFFFFFFF
# the key schedule's parity constant and the two rotation groups
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: Tuple[int, int], x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter words ``(x0, x1)`` (int64 tensors
    holding uint32 values) under ``key`` = (k0, k1) uint32 ints."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as a pair of uint32 ints."""
    s32 = int(seed) & MASK32         # the seed as the int32 JAX holds
    return 0, s32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    z = torch.zeros(1, dtype=torch.int64)
    o0, o1 = threefry2x32(key, z, z + (int(data) & MASK32))
    return int(o0[0]), int(o1[0])


def random_bits(key: Tuple[int, int], n: int,
                device=None) -> torch.Tensor:
    """The [n] uint32 words of ``jax.random.bits(key, (n,))`` in int64."""
    i = torch.arange(int(n), dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(key, i >> 32, i & MASK32)
    return o0 ^ o1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> f32 uniforms in [0, 1), as JAX maps them:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    word = (bits >> 9) | 0x3F800000
    return word.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Tuple[int, int], n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` (f32 in [0, 1))."""
    return bits_to_unit(random_bits(key, n, device))


def bagging_key(seed: int, epoch: int) -> Tuple[int, int]:
    """The bagging draw's key, ``fold_in(PRNGKey(seed), epoch)``."""
    return fold_in(prng_key(seed), epoch)


# --- B6: the bagging draw and the vals stack (csrc/sample.cu) -------------

def _f32(v: float, device=None) -> torch.Tensor:
    """A fraction rounded to f32, as JAX compares an f32 array with a
    Python float."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _check_bag(g, h, it, positive, out) -> None:
    n = g.shape[0] if g.dim() == 1 else -1
    for name, t in (("g", g), ("h", h)):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.float32:
            raise TypeError(f"{name} must be an [N] float32 tensor")
    if it.shape != (1,) or it.dtype != torch.int32:
        raise TypeError("it must be a [1] int32 tensor")
    tensors = [g, h, it]
    if positive is not None:
        if positive.shape != (n,) or positive.dtype != torch.uint8:
            raise TypeError("positive must be an [N] uint8 tensor")
        tensors.append(positive)
    if out is not None:
        if out.shape != (n, 3) or out.dtype != torch.float32:
            raise TypeError("out must be an [N, 3] float32 tensor")
        tensors.append(out)
    if any(t.device != g.device for t in tensors):
        raise ValueError("bag_vals inputs must be on one device")


def bag_vals(g: torch.Tensor, h: torch.Tensor, it: torch.Tensor, *,
             seed: int, freq: int, fraction: float,
             pos_fraction: float = 1.0, neg_fraction: float = 1.0,
             positive: torch.Tensor | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """B6: the [N, 3] f32 ``(g*w, h*w, w)`` of the in-bag mask ``w`` of
    iteration ``it`` (a [1] int32 device tensor): ``w = u < fraction``, or
    with ``positive`` (an [N] uint8 flag of label > 0, binary objectives
    with pos/neg fractions) ``positive ? u < pos_fraction : u <
    neg_fraction``, where ``u = uniform(bagging_key(seed, (it // freq) *
    freq), N)``.  CUDA tensors launch the kernel of ``csrc/sample.cu``,
    CPU tensors run ``bag_vals_plain``; both give the same bits."""
    _check_bag(g, h, it, positive, out)
    if int(freq) < 1:
        raise ValueError("bagging needs freq >= 1")
    kw = dict(seed=seed, freq=freq, fraction=fraction,
              pos_fraction=pos_fraction, neg_fraction=neg_fraction,
              positive=positive)
    if g.device.type == "cpu":
        vals = bag_vals_plain(g, h, it, **kw)
        return vals if out is None else out.copy_(vals)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if out is None:
        out = torch.empty((g.shape[0], 3), dtype=torch.float32,
                          device=g.device)
    if not all(t.is_contiguous() for t in (g, h, out)) or (
            positive is not None and not positive.is_contiguous()):
        raise ValueError("bag_vals needs contiguous tensors")
    k0, k1 = prng_key(seed)
    err = _kernels.lib("sample").lgbt_bag_vals(
        g.data_ptr(), h.data_ptr(),
        None if positive is None else positive.data_ptr(), g.shape[0],
        it.data_ptr(), k0, k1, int(freq), float(np.float32(fraction)),
        float(np.float32(pos_fraction)), float(np.float32(neg_fraction)),
        out.data_ptr(), _kernels.stream_ptr(g.device))
    _kernels.launched("bag_vals", err)
    return out


def bag_mask_plain(n: int, it: int, *, seed: int, freq: int,
                   fraction: float, pos_fraction: float = 1.0,
                   neg_fraction: float = 1.0,
                   positive: torch.Tensor | None = None,
                   device=None) -> torch.Tensor:
    """The [N] f32 in-bag mask of iteration ``it`` (a host int), in plain
    PyTorch."""
    epoch = (int(it) // int(freq)) * int(freq)
    u = uniform(bagging_key(seed, epoch), n, device)
    if positive is not None:
        m = torch.where(positive != 0, u < _f32(pos_fraction, device),
                        u < _f32(neg_fraction, device))
    else:
        m = u < _f32(fraction, device)
    return m.to(torch.float32)


def bag_vals_plain(g, h, it, *, seed, freq, fraction, pos_fraction=1.0,
                   neg_fraction=1.0, positive=None) -> torch.Tensor:
    """Plain PyTorch version of B6 (``bag_mask_plain`` and the stack),
    reading the iteration from ``it``."""
    w = bag_mask_plain(g.shape[0], int(it.cpu()[0]), seed=seed, freq=freq,
                       fraction=fraction, pos_fraction=pos_fraction,
                       neg_fraction=neg_fraction, positive=positive,
                       device=g.device)
    return torch.stack([g * w, h * w, w], dim=1)
