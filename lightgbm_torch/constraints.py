"""Host half of the split controls of the masked growers: monotone
constraints (``basic``), interaction constraints, ``feature_contri`` and
cost-effective gradient boosting (CEGB).

The port's own copy of the JAX package's host pieces (held equal to them
by tests/test_torch_constraints.py): the monotone vector over used-feature
slots (``models/gbdt.py`` :176-181), ``_interaction_allow`` (:1207-1234),
the ``feature_contri`` vector (:189-195), ``_make_cegb`` (:883-906) with
``CEGBState`` (``grower_partitioned.py`` :140-168, with the partitioned
learner's ``penalty_vector`` and ``mark_used``), and
``monotone_penalty_factor`` (``ops/split.py`` :132-142).  The arithmetic
is the JAX package's f32 host arithmetic, written in numpy with the same
operand types, so every vector has the same bits.

``device_constraints`` turns them into the device operands the growers
hand to kernels B2/B2-cat (the monotone vector, the penalty factor of
each depth, the contri scale, the CEGB slope and coupled penalty), to
B3s/B3s-K (the monotone vector and the interaction groups) and to
B6-node (the root's allowed features).  ``check_operands`` is the one
validator of the kernels' split-control operands (their types, shapes
and which go together).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch


class CEGBState(NamedTuple):
    """Cost-effective gradient boosting penalties
    (cost_effective_gradient_boosting.hpp:22-160): a per-split
    data-acquisition cost, per-feature coupled (once per model) and lazy
    (per data point, approximated by leaf size) penalties, scaled by
    ``cegb_tradeoff`` and subtracted from candidate gains.  ``used``
    persists across trees."""
    tradeoff: float
    penalty_split: float
    coupled: Optional[np.ndarray]     # [F] or None
    lazy: Optional[np.ndarray]        # [F] or None
    used: np.ndarray                  # [F] bool, mutated in place

    def penalty_vector(self, num_data_in_leaf: float) -> np.ndarray:
        """The [F] f32 penalty of a leaf of ``num_data_in_leaf`` rows, as
        the partitioned learner computes it on the host
        (``grower_partitioned.py`` :152-160)."""
        f = len(self.used)
        pen = np.full(f, self.tradeoff * self.penalty_split
                      * float(num_data_in_leaf), np.float32)
        if self.coupled is not None:
            pen += self.tradeoff * self.coupled * (~self.used)
        if self.lazy is not None:
            pen += self.tradeoff * self.lazy * float(num_data_in_leaf)
        return pen

    def mark_used(self, feature: int) -> None:
        self.used[feature] = True

    @property
    def active(self) -> bool:
        return (self.penalty_split > 0 or self.coupled is not None
                or self.lazy is not None)


def monotone_vector(config, ds) -> Optional[np.ndarray]:
    """[F] int32 -1/0/+1 over used-feature slots, None when no feature is
    constrained."""
    if not config.monotone_constraints:
        return None
    mc_full = np.zeros(ds.num_total_features, np.int32)
    mc_in = np.asarray(config.monotone_constraints, np.int32)
    mc_full[:len(mc_in)] = mc_in
    mono = mc_full[np.asarray(ds.used_features)]
    return mono if np.any(mono) else None


def interaction_allow(config, ds) -> Optional[np.ndarray]:
    """``interaction_constraints`` ("[0,1],[2,3]" over original feature
    indices) as a [G, F] group matrix over used-feature slots
    (col_sampler.hpp:91-111 GetByNode): a leaf may split on its branch
    features and on the union of the groups that contain its whole
    branch; features in no group are unusable."""
    spec = config.interaction_constraints
    if not spec:
        return None
    groups: List[List[int]] = []
    for part in spec.replace(" ", "").strip("[]").split("],["):
        if part:
            groups.append([int(t) for t in part.split(",") if t != ""])
    if not groups:
        return None
    slot_of_orig = {f: i for i, f in enumerate(ds.used_features)}
    nf = len(ds.used_features)
    gm = np.zeros((len(groups), nf), bool)
    for gi, grp in enumerate(groups):
        for member in grp:
            if member in slot_of_orig:
                gm[gi, slot_of_orig[member]] = True
    return gm


def contri_vector(config, ds) -> Optional[np.ndarray]:
    """``feature_contri``: the [F] f32 split-gain scale over used slots
    (1 for features past the list), None when not set."""
    if not config.feature_contri:
        return None
    fc = np.ones(ds.num_total_features, np.float32)
    vals_in = np.asarray(config.feature_contri, np.float32)
    fc[:len(vals_in)] = vals_in
    return fc[np.asarray(ds.used_features)]


def make_cegb(config, ds) -> Optional[CEGBState]:
    """CEGB penalties over used-feature slots, None when every penalty is
    off."""
    coupled_in = config.cegb_penalty_feature_coupled
    lazy_in = config.cegb_penalty_feature_lazy
    if config.cegb_penalty_split <= 0 and not coupled_in and not lazy_in:
        return None
    nf = len(ds.used_features)

    def slot_array(vals):
        if not vals:
            return None
        full = np.zeros(ds.num_total_features, np.float32)
        full[:len(vals)] = np.asarray(vals, np.float32)
        return full[np.asarray(ds.used_features)]

    return CEGBState(
        tradeoff=config.cegb_tradeoff,
        penalty_split=config.cegb_penalty_split,
        coupled=slot_array(coupled_in),
        lazy=slot_array(lazy_in),
        used=np.zeros(nf, bool))


def cegb_slope(cegb: CEGBState) -> np.ndarray:
    """The [F] f32 penalty per row of a candidate leaf: ``tradeoff *
    (penalty_split + lazy)``, in f32 when ``lazy`` is set and in f64
    rounded once otherwise (the JAX grower's expression, grower.py:481-484,
    with the same operand types)."""
    nf = len(cegb.used)
    lazy = cegb.lazy if cegb.lazy is not None else np.zeros(nf)
    return np.asarray(cegb.tradeoff * (cegb.penalty_split + lazy),
                      np.float32)


def cegb_coupled(cegb: CEGBState) -> Optional[np.ndarray]:
    """The [F] f32 once-per-model penalty of a feature not yet used,
    ``tradeoff * coupled``; None without coupled penalties."""
    if cegb.coupled is None:
        return None
    return np.asarray(cegb.tradeoff * cegb.coupled, np.float32)


def monotone_penalty_factor(penalty: float, depth) -> np.ndarray:
    """ComputeMonotoneSplitGainPenalty (monotone_constraints.hpp:355):
    the f32 gain factor of a monotone feature at ``depth`` (an int or an
    int array), in the JAX package's f32 operations: exact for integer
    penalties; where the exponent ``penalty - 1 - depth`` is not an
    integer, numpy's f32 power may round the last bit otherwise than
    XLA's."""
    pen = float(penalty)
    d = np.asarray(depth, np.float32)
    with np.errstate(over="ignore"):     # 2 ** d is inf past depth 127
        return np.asarray(np.where(
            pen >= d + 1.0, 1e-15,
            np.where(pen <= 1.0, 1.0 - pen / (2.0 ** d) + 1e-15,
                     1.0 - 2.0 ** (pen - 1.0 - d) + 1e-15)), np.float32)


class GrowConstraints(NamedTuple):
    """The device operands of the split controls, each None when off:
    ``mono`` [F] int8 (monotone basic), ``mono_factor`` [T] f32 (the
    monotone penalty factor of depth 0..T-1, with ``monotone_penalty``
    > 0), ``contri`` [F] f32, ``groups`` [G, F] bool (interaction
    groups) with ``root_allow`` [F] bool (their union: the root's allowed
    features), ``cegb_slope`` [F] f32 and ``cegb_coupled`` [F] f32."""
    mono: Optional[torch.Tensor] = None
    mono_factor: Optional[torch.Tensor] = None
    contri: Optional[torch.Tensor] = None
    groups: Optional[torch.Tensor] = None
    root_allow: Optional[torch.Tensor] = None
    cegb_slope: Optional[torch.Tensor] = None
    cegb_coupled: Optional[torch.Tensor] = None

    @property
    def cegb(self) -> bool:
        return self.cegb_slope is not None


def check_operands(ops, want: dict, together=(), needs=()) -> list:
    """Check the split-control operands ``ops`` (a NamedTuple of tensors,
    None where a control is off) before their pointers go to a kernel:
    ``want`` maps each field to its (shape, dtype), a shape entry None
    matching any size and a shape None any non-empty vector; the fields
    of each tuple in ``together`` are set all or none; in each pair (a,
    b) of ``needs`` b is set wherever a is.  Returns the tensors that are
    set, all contiguous."""
    out = []
    for name, t in ops._asdict().items():
        if t is None:
            continue
        shape, dtype = want[name]
        if shape is None:
            fits = t.dim() == 1 and t.numel() > 0
        else:
            fits = t.dim() == len(shape) and all(
                w is None or w == s for w, s in zip(shape, t.shape))
        if t.dtype != dtype or not fits or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dtype} tensor "
                            f"of shape {list(shape) if shape else '[T]'}")
        out.append(t)
    for names in together:
        on = [getattr(ops, n) is not None for n in names]
        if any(on) and not all(on):
            raise ValueError(f"{', '.join(names)} go together")
    for a, b in needs:
        if getattr(ops, a) is not None and getattr(ops, b) is None:
            raise ValueError(f"{a} needs {b}")
    return out


def device_constraints(num_leaves: int, device, mono=None,
                       mono_penalty: float = 0.0, contri=None, groups=None,
                       cegb: Optional[CEGBState] = None
                       ) -> Optional[GrowConstraints]:
    """``GrowConstraints`` on ``device`` from the host vectors above, or
    None when every control is off.  The penalty factor table covers
    every depth a tree of ``num_leaves`` leaves can reach."""
    on_mono = mono is not None and bool(np.any(mono))
    if not (on_mono or contri is not None or groups is not None
            or (cegb is not None and cegb.active)):
        return None

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    kw = {}
    if on_mono:
        kw["mono"] = dev(np.asarray(mono, np.int8), torch.int8)
        if float(mono_penalty) > 0.0:
            kw["mono_factor"] = dev(monotone_penalty_factor(
                mono_penalty, np.arange(int(num_leaves) + 1)), torch.float32)
    if contri is not None:
        kw["contri"] = dev(np.asarray(contri, np.float32), torch.float32)
    if groups is not None:
        gm = np.asarray(groups, bool)
        kw["groups"] = dev(gm, torch.bool)
        kw["root_allow"] = dev(gm.any(axis=0), torch.bool)
    if cegb is not None and cegb.active:
        kw["cegb_slope"] = dev(cegb_slope(cegb), torch.float32)
        coupled = cegb_coupled(cegb)
        if coupled is not None:
            kw["cegb_coupled"] = dev(coupled, torch.float32)
    return GrowConstraints(**kw)
