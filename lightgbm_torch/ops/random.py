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
A shape of more than one axis draws the flat (row-major) counter stream:
``uniform(key, (C, F))[c, f]`` is word ``c * F + f``.

The draws that key on it:

- bagging (B6, ``bag_vals``): ``bagging_key(seed, epoch)`` =
  ``fold_in(PRNGKey(seed), epoch)``;
- GOSS (B6-GOSS, ``goss_vals``): ``goss_key(seed, it)`` =
  ``PRNGKey(seed + it)``, no fold (the JAX package's ``_goss_vals``);
- the growers' per-node draws (B6-node, ``node_draws``):
  ``node_key(seed, rng_iter)`` = ``fold_in(PRNGKey(seed), rng_iter)``,
  then one fold per step id (the JAX grower's ``_bynode_mask`` and
  ``_rand_bins``).

``tests/test_torch_random.py`` pins every function to ``jax.random``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import _kernels

MASK32 = 0xFFFFFFFF
# the key schedule's parity constant and the two rotation groups
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter words ``(x0, x1)`` (int64 tensors
    holding uint32 values) under ``key`` = (k0, k1): uint32 ints, or int64
    tensors of uint32 values that broadcast against the counters (one key
    a row: the per-query keys of ``ops/rank.py``)."""
    k0, k1 = ((k & MASK32) if torch.is_tensor(k) else int(k) & MASK32
              for k in key)
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


def uniform(key: Tuple[int, int], shape: Union[int, Tuple[int, ...]],
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (f32 in [0, 1)); ``shape`` an
    int (one axis) or a tuple, drawn as the flat counter stream."""
    shape = (int(shape),) if np.ndim(shape) == 0 else \
        tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    return bits_to_unit(random_bits(key, n, device)).reshape(shape)


def bagging_key(seed: int, epoch: int) -> Tuple[int, int]:
    """The bagging draw's key, ``fold_in(PRNGKey(seed), epoch)``."""
    return fold_in(prng_key(seed), epoch)


def goss_key(seed: int, it: int) -> Tuple[int, int]:
    """The GOSS draw's key of iteration ``it``, ``PRNGKey(seed + it)``
    (the sum taken modulo 2^32, as the JAX package's int32 iteration
    wraps it)."""
    return prng_key(int(seed) + int(it))


def node_key(seed: int, rng_iter: int) -> Tuple[int, int]:
    """A grower's per-iteration key of the node draws,
    ``fold_in(PRNGKey(seed), rng_iter)``."""
    return fold_in(prng_key(seed), rng_iter)


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
        raise ValueError("sampling draw inputs must be on one device")


def bag_vals(g: torch.Tensor, h: torch.Tensor, it: torch.Tensor, *,
             seed: int, freq: int, fraction: float,
             pos_fraction: float = 1.0, neg_fraction: float = 1.0,
             positive: torch.Tensor | None = None,
             out: torch.Tensor | None = None,
             fold: int | None = None) -> torch.Tensor:
    """B6: the [N, 3] f32 ``(g*w, h*w, w)`` of the in-bag mask ``w`` of
    iteration ``it`` (a [1] int32 device tensor): ``w = u < fraction``, or
    with ``positive`` (an [N] uint8 flag of label > 0, binary objectives
    with pos/neg fractions) ``positive ? u < pos_fraction : u <
    neg_fraction``, where ``u = uniform(bagging_key(seed, (it // freq) *
    freq), N)``; with ``fold`` (a data-parallel rank) the key is
    ``fold_in`` of that key and ``fold``, as the JAX package's
    multi-process ``_bagging_w`` draws a rank's own mask.  CUDA tensors
    launch the kernel of ``csrc/sample.cu``, CPU tensors run
    ``bag_vals_plain``; both give the same bits."""
    _check_bag(g, h, it, positive, out)
    if int(freq) < 1:
        raise ValueError("bagging needs freq >= 1")
    if fold is not None and int(fold) < 0:
        raise ValueError("fold must be a rank >= 0")
    kw = dict(seed=seed, freq=freq, fraction=fraction,
              pos_fraction=pos_fraction, neg_fraction=neg_fraction,
              positive=positive, fold=fold)
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
        it.data_ptr(), k0, k1, int(freq), -1 if fold is None else int(fold),
        float(np.float32(fraction)),
        float(np.float32(pos_fraction)), float(np.float32(neg_fraction)),
        out.data_ptr(), _kernels.stream_ptr(g.device))
    _kernels.launched("bag_vals", err)
    return out


def bag_mask_plain(n: int, it: int, *, seed: int, freq: int,
                   fraction: float, pos_fraction: float = 1.0,
                   neg_fraction: float = 1.0,
                   positive: torch.Tensor | None = None,
                   device=None, fold: int | None = None) -> torch.Tensor:
    """The [N] f32 in-bag mask of iteration ``it`` (a host int), in plain
    PyTorch; ``fold`` as ``bag_vals``."""
    epoch = (int(it) // int(freq)) * int(freq)
    key = bagging_key(seed, epoch)
    if fold is not None:
        key = fold_in(key, int(fold))
    u = uniform(key, n, device)
    if positive is not None:
        m = torch.where(positive != 0, u < _f32(pos_fraction, device),
                        u < _f32(neg_fraction, device))
    else:
        m = u < _f32(fraction, device)
    return m.to(torch.float32)


def bag_vals_plain(g, h, it, *, seed, freq, fraction, pos_fraction=1.0,
                   neg_fraction=1.0, positive=None, fold=None
                   ) -> torch.Tensor:
    """Plain PyTorch version of B6 (``bag_mask_plain`` and the stack),
    reading the iteration from ``it``."""
    w = bag_mask_plain(g.shape[0], int(it.cpu()[0]), seed=seed, freq=freq,
                       fraction=fraction, pos_fraction=pos_fraction,
                       neg_fraction=neg_fraction, positive=positive,
                       device=g.device, fold=fold)
    return torch.stack([g * w, h * w, w], dim=1)


# --- B6-GOSS: the top-k threshold, the keyed draw and the weights ----------

def goss_constants(n: int, top_rate: float,
                   other_rate: float) -> Tuple[int, np.float32, np.float32]:
    """(top_k, p_other, amp) of GOSS over ``n`` rows, formed as the JAX
    package's ``_goss_vals`` forms them: ``top_k = max(1, int(n *
    top_rate))`` in Python floats; ``p_other`` the f32 quotient of
    ``other_k`` and ``max(n - top_k, 1)``, each converted to f32; ``amp``
    the Python quotient ``(1 - top_rate) / other_rate`` rounded to f32."""
    n = int(n)
    top_k = max(1, int(n * top_rate))
    other_k = max(1, int(n * other_rate))
    p_other = np.float32(other_k) / np.float32(max(n - top_k, 1))
    amp = np.float32((1.0 - top_rate) / other_rate)
    return top_k, p_other, amp


def goss_weights_plain(g: torch.Tensor, h: torch.Tensor, it: int, *,
                       seed: int, top_rate: float,
                       other_rate: float) -> torch.Tensor:
    """The [N] f32 GOSS weights of iteration ``it`` (a host int), in plain
    PyTorch: 1 where ``|g| * h`` reaches the ``top_k``-th largest value
    (every tie included), ``amp`` where another row's uniform of
    ``goss_key(seed, it)`` is below ``p_other``, else 0.  The threshold is
    the JAX package's ``-sort(-a)[top_k - 1]`` (NaN ranks lowest; an index
    past the end takes the last, as JAX clamps it)."""
    n = g.shape[0]
    top_k, p_other, amp = goss_constants(n, top_rate, other_rate)
    a = g.abs() * h
    thresh = -torch.sort(-a).values[min(top_k, n) - 1]
    is_top = a >= thresh
    u = uniform(goss_key(seed, it), n, g.device)
    is_other = ~is_top & (u < torch.tensor(p_other, device=g.device))
    one = torch.ones((), dtype=torch.float32, device=g.device)
    return torch.where(is_top, one, torch.where(
        is_other, torch.tensor(amp, device=g.device), one * 0.0))


def goss_vals_plain(g, h, it, *, seed, top_rate, other_rate) -> torch.Tensor:
    """Plain PyTorch version of B6-GOSS (``goss_weights_plain`` and the
    stack), reading the iteration from ``it``."""
    w = goss_weights_plain(g, h, int(it.cpu()[0]), seed=seed,
                           top_rate=top_rate, other_rate=other_rate)
    return torch.stack([g * w, h * w, w], dim=1)


# scratch of the kernel's radix select: the [3, 2048] digit histograms of
# its three passes and its state (the key prefix found so far, the rank
# still to find)
GOSS_HIST_WORDS = 3 * 2048
GOSS_STATE_WORDS = 4


class GossBuffers(NamedTuple):
    """The scratch of one B6-GOSS launch: the [N] int32 select keys and
    the [GOSS_HIST_WORDS + GOSS_STATE_WORDS] int32 histograms and state.
    A caller that draws every iteration allocates them once."""
    keys: torch.Tensor
    scratch: torch.Tensor


def goss_buffers(n: int, device) -> GossBuffers:
    """Scratch for ``goss_vals`` over ``n`` rows on ``device``."""
    return GossBuffers(
        torch.empty(int(n), dtype=torch.int32, device=device),
        torch.empty(GOSS_HIST_WORDS + GOSS_STATE_WORDS, dtype=torch.int32,
                    device=device))


def goss_vals(g: torch.Tensor, h: torch.Tensor, it: torch.Tensor, *,
              seed: int, top_rate: float, other_rate: float,
              out: torch.Tensor | None = None,
              buffers: GossBuffers | None = None) -> torch.Tensor:
    """B6-GOSS: the [N, 3] f32 ``(g*w, h*w, w)`` of the GOSS weights ``w``
    of iteration ``it`` (a [1] int32 device tensor; see
    ``goss_weights_plain``).  CUDA tensors launch the kernels of
    ``csrc/sample.cu`` (an exact radix select of the threshold, then one
    thread a row), with no host synchronisation, in ``buffers`` (from
    ``goss_buffers``; allocated for the call when None); CPU tensors run
    ``goss_vals_plain``.  Both give the same bits."""
    _check_bag(g, h, it, None, out)
    if buffers is not None:
        keys, scratch = buffers
        if keys.shape != (g.shape[0],) or keys.dtype != torch.int32 \
                or scratch.shape != (GOSS_HIST_WORDS + GOSS_STATE_WORDS,) \
                or scratch.dtype != torch.int32:
            raise TypeError("buffers must be goss_buffers(N, device)")
        if keys.device != g.device or scratch.device != g.device:
            raise ValueError("sampling draw inputs must be on one device")
    kw = dict(seed=seed, top_rate=top_rate, other_rate=other_rate)
    n = g.shape[0]
    top_k, p_other, amp = goss_constants(n, top_rate, other_rate)
    if g.device.type == "cpu":
        vals = goss_vals_plain(g, h, it, **kw)
        return vals if out is None else out.copy_(vals)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if out is None:
        out = torch.empty((n, 3), dtype=torch.float32, device=g.device)
    if not all(t.is_contiguous() for t in (g, h, out)):
        raise ValueError("goss_vals needs contiguous tensors")
    if n == 0:
        return out
    keys, scratch = goss_buffers(n, g.device) if buffers is None \
        else buffers
    err = _kernels.lib("sample").lgbt_goss_vals(
        g.data_ptr(), h.data_ptr(), n, it.data_ptr(),
        int(seed) & MASK32, min(top_k, n), float(p_other), float(amp),
        keys.data_ptr(), scratch.data_ptr(),
        scratch[GOSS_HIST_WORDS:].data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(g.device))
    _kernels.launched("goss_vals", err)
    return out


# --- B6-node: the growers' per-child feature subsets and random bins -------

class NodeSampling(NamedTuple):
    """The growers' per-node draws: ``feature_fraction_bynode`` (on when
    0 < ``bynode_frac`` < 1; the JAX package seeds it with
    ``feature_fraction_seed + 1``) and ``extra_trees`` (seeded by
    ``extra_seed``)."""
    bynode_frac: float = 1.0
    bynode_seed: int = 0
    extra_trees: bool = False
    extra_seed: int = 6

    @property
    def bynode(self) -> bool:
        return 0.0 < float(self.bynode_frac) < 1.0

    @property
    def on(self) -> bool:
        return self.bynode or bool(self.extra_trees)


def bynode_count(nvalid: int, frac: float) -> int:
    """Features a bynode subset keeps of ``nvalid``: ``max(1,
    ceil(f32(nvalid) * f32(frac)))`` in f32, as the JAX package computes
    it (f64 can differ: 25 x 0.6 gives 16 in f32 and 15 in f64)."""
    return int(max(np.float32(1.0),
                   np.ceil(np.float32(nvalid) * np.float32(frac))))


def bynode_keep(u: torch.Tensor, base: torch.Tensor, k) -> torch.Tensor:
    """The rank step of a bynode draw: of the features in ``base`` ([..., F]
    bool), keep those whose uniform ``u`` has stable rank < ``k`` (an int,
    or a tensor broadcasting over the leading axes); features outside
    ``base`` rank last (+inf), and ties go to the lower index, as JAX's
    ``argsort(argsort(u))``."""
    inf = torch.full((), float("inf"), device=u.device)
    u = torch.where(base, u, inf)
    rank = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1,
                         stable=True)
    if torch.is_tensor(k):
        k = k[..., None]
    return base & (rank < k)


def bynode_mask_plain(key: Tuple[int, int], base: torch.Tensor,
                      frac: float) -> torch.Tensor:
    """The JAX grower's ``_bynode_mask(key, base)``: one random subset of
    ``bynode_count(|base|, frac)`` features drawn from ``base`` [F]."""
    u = uniform(key, base.shape[0], base.device)
    return bynode_keep(u, base, bynode_count(int(base.sum()), frac))


def rand_bins_plain(key: Tuple[int, int], shape, num_bin: torch.Tensor
                    ) -> torch.Tensor:
    """The JAX grower's ``_rand_bins(key, shape, num_bin)``: one threshold
    bin a feature (``shape`` [..., F]), ``min(int(u * f32(max(num_bin -
    1, 1))), num_bin - 2)`` (int32)."""
    u = uniform(key, shape, num_bin.device)
    span = num_bin.clamp_min(2).sub(1).to(torch.float32)
    return torch.minimum((u * span).to(torch.int32),
                         (num_bin - 2).to(torch.int32))


def node_draws_plain(base: torch.Tensor, num_bin: torch.Tensor,
                     rng_iter: torch.Tensor, *, count: int, bynode_id0: int,
                     extra_step: int, sampling: NodeSampling
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B6-node: the ``count`` children's [C, F]
    bool masks (child c: ``bynode_mask_plain`` of
    ``fold_in(node_key(bynode_seed, rng_iter), bynode_id0 + c)`` over
    ``base``, or over child c's own row of a [C, F] ``base``) and [C, F]
    int32 random bins (``rand_bins_plain`` of
    ``fold_in(node_key(extra_seed, rng_iter), extra_step)`` at shape (C,
    F)).  A draw that is off gives ``base`` repeated, or zeros."""
    it = int(rng_iter.cpu()[0])
    C, F = int(count), base.shape[-1]
    rows = base.expand(C, F)
    masks = rows.clone()
    bins = torch.zeros((C, F), dtype=torch.int32, device=base.device)
    if sampling.bynode:
        bk = node_key(sampling.bynode_seed, it)
        masks = torch.stack([bynode_mask_plain(fold_in(bk, bynode_id0 + c),
                                               rows[c], sampling.bynode_frac)
                             for c in range(C)])
    if sampling.extra_trees:
        ek = fold_in(node_key(sampling.extra_seed, it), extra_step)
        bins = rand_bins_plain(ek, (C, F), num_bin)
    return masks, bins


# most features a bynode draw takes (its uniforms live in the 48 KB of
# shared memory a block has without opting in; extra_trees alone needs
# none)
NODE_DRAW_MAX_FEATURES = 12000


def node_draws(base: torch.Tensor, num_bin: torch.Tensor,
               rng_iter: torch.Tensor, *, count: int, bynode_id0: int,
               extra_step: int, sampling: NodeSampling,
               masks: torch.Tensor, bins: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> None:
    """B6-node, in place on ``masks`` [C, F] bool and ``bins`` [C, F]
    int32 (C = ``count``): the per-child feature subsets and random
    threshold bins of one grower step (``node_draws_plain``), each child's
    subset drawn from ``base`` [F], or from its own row of ``base`` [C, F]
    (the children's allowed features under interaction constraints).  Only the
    draws that are on are written.  ``rng_iter``: the device iteration (a
    [1] int32 tensor); ``active`` (a [1] int32 device tensor, the step's
    flag): where it is 0 nothing is written.  CUDA tensors launch the
    kernel of ``csrc/sample.cu``, CPU tensors run ``node_draws_plain``;
    both give the same bits."""
    C, F = int(count), base.shape[-1]
    if base.shape not in ((F,), (C, F)) or base.dtype != torch.bool:
        raise TypeError("base must be a [F] or [count, F] bool tensor")
    if num_bin.shape != (F,) or num_bin.dtype != torch.int32:
        raise TypeError("num_bin must be a [F] int32 tensor")
    if rng_iter.shape != (1,) or rng_iter.dtype != torch.int32:
        raise TypeError("rng_iter must be a [1] int32 tensor")
    if masks.shape != (C, F) or masks.dtype != torch.bool \
            or bins.shape != (C, F) or bins.dtype != torch.int32:
        raise TypeError("masks and bins must be [count, F] bool and int32")
    tensors = [num_bin, rng_iter, masks, bins]
    if active is not None:
        if active.shape != (1,) or active.dtype != torch.int32:
            raise TypeError("active must be a [1] int32 tensor")
        tensors.append(active)
    if any(t.device != base.device for t in tensors):
        raise ValueError("node_draws inputs must be on one device")
    kw = dict(count=C, bynode_id0=bynode_id0, extra_step=extra_step,
              sampling=sampling)
    if base.device.type == "cpu":
        if active is not None and not bool(active[0]):
            return
        m, b = node_draws_plain(base, num_bin, rng_iter, **kw)
        if sampling.bynode:
            masks.copy_(m)
        if sampling.extra_trees:
            bins.copy_(b)
        return
    if base.device.type != "cuda":
        raise ValueError(f"unsupported device {base.device}")
    if not all(t.is_contiguous() for t in [base, *tensors]):
        raise ValueError("node_draws needs contiguous tensors")
    if sampling.bynode and F > NODE_DRAW_MAX_FEATURES:
        raise ValueError(f"node_draws takes at most "
                         f"{NODE_DRAW_MAX_FEATURES} features (has {F})")
    bk = prng_key(sampling.bynode_seed)
    ek = prng_key(sampling.extra_seed)
    err = _kernels.lib("sample").lgbt_node_draws(
        base.data_ptr(), F if base.dim() == 2 else 0, num_bin.data_ptr(), F,
        C, rng_iter.data_ptr(),
        None if active is None else active.data_ptr(),
        int(sampling.bynode), bk[0], bk[1], int(bynode_id0) & MASK32,
        float(np.float32(sampling.bynode_frac)), int(sampling.extra_trees),
        ek[0], ek[1], int(extra_step) & MASK32, masks.data_ptr(),
        bins.data_ptr(), _kernels.stream_ptr(base.device))
    _kernels.launched("node_draws", err)
