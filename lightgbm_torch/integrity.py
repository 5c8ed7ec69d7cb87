"""Computation integrity: silent-data-corruption (SDC) detection and
suspect-device quarantine (the JAX package's ``integrity.py``).

The other robustness layers defend against failures that announce
themselves.  This one defends against the marginal card that keeps
running but computes wrong numbers: one flipped bit in a histogram
silently changes every later tree.  The grower is deterministic (B1 sums
in an order fixed by the shapes, the integer histograms are exact), so a
second run of it is an exact oracle.

**Detection** (``models/fused.py``, the checked iteration, on the
per-iteration loop only).  Every iteration, the in-graph invariants of
the new tree (kernel B17a, :func:`invariant_flags`: count conservation
down the tree, leaf counts summing to the root's, finite gains) give one
flag that rides the iteration's integrity fetch.  Every
``integrity_check_freq``-th iteration the tree is grown again by the
shadow grower (``grower.make_shadow_grower``: the same grower over its
own workspace, its kernels from a second, separately built and loaded set
of the grower's libraries) and its tree words ride the same fetch; the
two trees are compared field by field (bitwise on int fields,
``integrity_ulp_tol`` ulps on f32 ones, :func:`compare_tree_arrays`).
On those iterations the score update's gather is re-gathered by a kernel
of its own (B17b, :func:`score_mismatch`) and compared on the device:
one more int32 fetch.

**Transient vs sticky.**  A mismatch is re-run once (a fresh primary grow
into the same workspace and a fresh shadow).  A clean re-run is a
transient: absorbed, the re-run's tree is the iteration's, so the model
is byte-identical to an uninjected run.  A second mismatch is sticky:
the suspect device is attributed, an ``elastic.*`` failure recorded, and
:class:`IntegrityFailure` (``ElasticFailure`` kind ``"sdc"``) raised.
Policy ``quarantine`` also marks the suspect device
(``parallel/elastic.mark_suspect``); ``rewind`` (re-entering training
from the newest verified snapshot) is ROADMAP A12, as are the callers of
:meth:`IntegrityChecker.boundary_check` and
:meth:`IntegrityChecker.manifest`.

Fault injection: sites ``hist_sdc`` and ``score_sdc`` with the
``bitflip`` action (``utils/faultinject.maybe_bitflip``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .grower import host_tree, tree_layout
from .obs.metrics import MetricsRegistry
from .parallel.elastic import ElasticFailure, _on_failure, mark_suspect
from .utils import faultinject
from .utils.log import Log

# the sticky-SDC rewind budget of one training entry (policy rewind,
# ROADMAP A12)
MAX_REWINDS = 3

# integrity.* metrics: host-side counter bumps on check and mismatch
# paths only
_REGISTRY = MetricsRegistry()
_REGISTRY_LOCK = threading.Lock()

# B17b's blocks (four an SM of an H100)
_SCORE_BLOCKS = 528


def metrics_snapshot() -> dict:
    """Deterministic dict snapshot of the ``integrity.*`` metrics."""
    return _REGISTRY.snapshot()


def reset_metrics() -> None:
    """Drop all ``integrity.*`` metric state."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()


def _metrics() -> MetricsRegistry:
    with _REGISTRY_LOCK:
        return _REGISTRY


class IntegrityFailure(ElasticFailure):
    """A sticky computation-integrity mismatch (it survived the one
    re-check), an ``ElasticFailure`` of kind ``"sdc"``.  Carries the
    1-based iteration it fired on, the attributed suspect device ids and
    the divergent-field summary."""

    def __init__(self, detail: str = "", iteration: Optional[int] = None,
                 devices: Tuple[int, ...] = (),
                 divergences: Tuple[Dict[str, Any], ...] = ()):
        self.iteration = iteration
        self.devices = tuple(devices)
        self.divergences = tuple(divergences)
        super().__init__("sdc", detail)


# ---------------------------------------------------------------------------
# Comparison primitives (host numpy; operands come off the one fetch)
# ---------------------------------------------------------------------------

def _float_ord(x: np.ndarray) -> np.ndarray:
    """Monotone-within-sign int64 key of f32 bit patterns: the distance
    between two same-sign keys is their ulp distance."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i >= 0, i, (np.int64(1) << 31) - 1 - i)


def ulp_delta(a, b) -> np.ndarray:
    """Elementwise ulp distance between two f32 arrays (0 where equal,
    including NaN==NaN and -0.0==+0.0)."""
    av = np.asarray(a, np.float32)
    bv = np.asarray(b, np.float32)
    same = (av == bv) | (np.isnan(av) & np.isnan(bv))
    d = np.abs(_float_ord(av) - _float_ord(bv))
    return np.where(same, 0, d)


def compare_tree_arrays(a, b, ulp_tol: int = 0) -> List[Dict[str, Any]]:
    """Field-by-field compare of two host ``TreeArrays``
    (``grower.host_tree``): bitwise on int/bool fields, ``ulp_tol``-bounded
    on floats.  One record per divergent field, ``{"field", "count",
    "index", "got", "want", "ulp"}`` with the first divergent element as
    the sample; an empty list is a match.  ``leaf_of_row`` (never
    fetched) is skipped."""
    out: List[Dict[str, Any]] = []
    for name, av, bv in zip(type(a)._fields, a, b):
        if name == "leaf_of_row":
            continue
        av = np.asarray(av)
        bv = np.asarray(bv)
        if av.shape != bv.shape:
            out.append({"field": name, "count": -1,
                        "got": list(av.shape), "want": list(bv.shape),
                        "index": -1, "ulp": -1})
            continue
        if np.issubdtype(av.dtype, np.floating):
            d = ulp_delta(av, bv)
            bad = d > ulp_tol
        else:
            bad = np.asarray(av != bv)
            d = bad.astype(np.int64)
        if not bad.any():
            continue
        idx = int(np.argmax(bad.ravel()))
        out.append({
            "field": name,
            "count": int(bad.sum()),
            "index": idx,
            "got": float(np.ravel(av)[idx]) if av.ndim else float(av),
            "want": float(np.ravel(bv)[idx]) if bv.ndim else float(bv),
            "ulp": int(np.ravel(d)[idx]),
        })
    return out


# ---------------------------------------------------------------------------
# B17a: the tree invariants
# ---------------------------------------------------------------------------

_INVARIANT_FIELDS = ("num_leaves", "left_child", "right_child", "split_gain",
                     "internal_count", "leaf_count")


def _check_tree(tree: torch.Tensor, num_leaves: int) -> Dict[str, tuple]:
    lay = tree_layout(num_leaves)
    need = max(off + n for off, n, _ in lay.values())
    if tree.dtype != torch.int32 or tree.dim() != 1 \
            or tree.numel() < need:
        raise TypeError(f"the tree buffer must be int32 words of the "
                        f"{num_leaves}-leaf layout (grower.tree_layout)")
    return lay


def invariant_flags(tree: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """The in-graph invariants of a freshly grown tree (kernel B17a; the
    JAX package's ``integrity.invariant_flags`` :179) as a [1] int32 flag,
    1 where they hold, on ``tree``'s device: over the live internal
    nodes, count conservation (each node's count against its children's,
    within 0.5 + 1e-3 of the count) and finite split gains; over the live
    leaves, their counts summing to the root's within the same slack.
    ``tree`` is the grower's int32 tree buffer for ``num_leaves`` leaves
    (``grower.TREE_FIELDS``; the categorical fields, if any, after).
    Counts are f32 weight sums, so conservation is checked with that
    slack, in f32.  CUDA tensors launch the kernel of
    ``csrc/integrity.cu``, CPU tensors run ``invariant_flags_plain``."""
    lay = _check_tree(tree, num_leaves)
    if tree.device.type == "cpu":
        return invariant_flags_plain(tree, num_leaves)
    if tree.device.type != "cuda":
        raise ValueError(f"unsupported device {tree.device}")
    if not tree.is_contiguous():
        raise ValueError("invariant_flags needs a contiguous tree buffer")
    flag = torch.empty(1, dtype=torch.int32, device=tree.device)
    err = _kernels.lib("integrity").lgbt_invariant_flags(
        tree.data_ptr(), int(num_leaves),
        *(lay[name][0] for name in _INVARIANT_FIELDS), flag.data_ptr(),
        _kernels.stream_ptr(tree.device))
    _kernels.launched("invariant_flags", err)
    return flag


def invariant_flags_plain(tree: torch.Tensor,
                          num_leaves: int) -> torch.Tensor:
    """Plain PyTorch version of B17a, the JAX function's arithmetic on the
    tree buffer's fields: children's counts gathered with clipped indices
    and added in f32, slacks and comparisons in f32; the live leaf counts
    summed in f64 and rounded once to f32 (as the kernel sums them)."""
    lay = _check_tree(tree, num_leaves)
    L = int(num_leaves)

    def field(name):
        off, n, kind = lay[name]
        v = tree[off:off + n]
        return v.view(torch.float32) if kind == "f" else v

    lc, ic = field("leaf_count"), field("internal_count")
    nl = int(field("num_leaves")[0])
    nnode = L - 1

    def child_count(c):
        c = c.to(torch.int64)
        leaf = c < 0
        li = torch.where(leaf, ~c, torch.zeros_like(c)).clamp(0, L - 1)
        ni = torch.where(leaf, torch.zeros_like(c), c).clamp(
            0, max(nnode - 1, 0))
        return torch.where(leaf, lc.index_select(0, li),
                           ic.index_select(0, ni))

    live = max(min(nl - 1, nnode), 0)
    ic_l = ic[:live]
    kid = child_count(field("left_child")[:live]) \
        + child_count(field("right_child")[:live])
    slack = 0.5 + 1e-3 * ic_l.abs()
    conserve_ok = bool(((ic_l - kid).abs() <= slack).all())
    gain_ok = bool(torch.isfinite(field("split_gain")[:live]).all())
    tot = lc[:max(min(nl, L), 0)].to(torch.float64).sum().to(torch.float32)
    root = ic[0] if (nl > 1 and nnode > 0) else lc[0]
    total_ok = bool((tot - root).abs() <= 0.5 + 1e-3 * root.abs())
    return torch.tensor([int(conserve_ok and total_ok and gain_ok)],
                        dtype=torch.int32, device=tree.device)


# ---------------------------------------------------------------------------
# B17b: the score re-gather
# ---------------------------------------------------------------------------

def _check_score(lv, leaf_of_row, delta) -> None:
    if lv.dtype != torch.float32 or lv.dim() != 1 \
            or leaf_of_row.dtype != torch.int32 \
            or delta.dtype != torch.float32 \
            or leaf_of_row.shape != delta.shape or delta.dim() != 1:
        raise TypeError("score_mismatch needs lv [L] f32, leaf_of_row [N] "
                        "int32 and delta [N] f32")
    if not (lv.device == leaf_of_row.device == delta.device):
        raise ValueError("score_mismatch inputs must be on one device")


def score_mismatch(lv: torch.Tensor, leaf_of_row: torch.Tensor,
                   delta: torch.Tensor) -> torch.Tensor:
    """The independent re-gather of the score update (kernel B17b; the
    JAX package's ``IntegrityChecker.verify_score`` :361-397, its
    separately jitted ``take`` and compare): a [1] int32 flag, 1 where
    some row has ``lv[leaf_of_row[r]] != delta[r]`` (or a leaf index
    outside ``lv``), on the device.  CUDA tensors launch the kernel of
    ``csrc/integrity.cu``, CPU tensors run ``score_mismatch_plain``."""
    _check_score(lv, leaf_of_row, delta)
    if lv.device.type == "cpu":
        return score_mismatch_plain(lv, leaf_of_row, delta)
    if lv.device.type != "cuda":
        raise ValueError(f"unsupported device {lv.device}")
    if not (lv.is_contiguous() and leaf_of_row.is_contiguous()
            and delta.is_contiguous()):
        raise ValueError("score_mismatch needs contiguous tensors")
    flag = torch.zeros(1, dtype=torch.int32, device=lv.device)
    n = delta.numel()
    err = _kernels.lib("integrity").lgbt_score_check(
        lv.data_ptr(), lv.numel(), leaf_of_row.data_ptr(), delta.data_ptr(),
        n, max(1, min(_SCORE_BLOCKS, -(-n // 256))), flag.data_ptr(),
        _kernels.stream_ptr(lv.device))
    _kernels.launched("score_recheck", err)
    return flag


def score_mismatch_plain(lv: torch.Tensor, leaf_of_row: torch.Tensor,
                         delta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B17b: the gather and the compare."""
    _check_score(lv, leaf_of_row, delta)
    L = lv.numel()
    lor = leaf_of_row.to(torch.int64)
    inside = (lor >= 0) & (lor < L)
    got = lv.index_select(0, lor.clamp(0, max(L - 1, 0))) if L else \
        torch.zeros_like(delta)
    bad = (~inside | (got != delta)).any()
    return bad.to(torch.int32).reshape(1)


def attribute_devices(x) -> List[int]:
    """The suspect device of a divergent tensor: the card's index on
    CUDA, none on the CPU (one device a model: the JAX package's
    single-device case, which names that chip exactly)."""
    dev = getattr(x, "device", None)
    if dev is None or dev.type != "cuda":
        return []
    return [int(dev.index if dev.index is not None else 0)]


class IntegrityChecker:
    """Per-model state and checks of the integrity layer
    (``GBDTModel._integrity``, made only when ``integrity_check_freq >
    0``), owned by the one training thread.

    ``shadow_fn`` is the shadow twin of the model's grower
    (``grower.make_shadow_grower``); ``independent`` records whether it
    runs a second, separately built set of kernels (on the card) or the
    same plain functions again (on the CPU), for the manifest.
    ``layout`` is the tree buffer's (num_leaves, num_bins, cat_bins)."""

    def __init__(self, config, shadow_fn, independent: bool,
                 layout: Tuple[int, int, int]):
        self.freq = int(config.integrity_check_freq)
        self.policy = str(config.integrity_policy)
        self.ulp_tol = int(config.integrity_ulp_tol)
        self.shadow_fn = shadow_fn
        self.independent = bool(independent)
        self.layout = tuple(int(v) for v in layout)
        self.checks = 0
        self.transients = 0
        # newest 1-based iteration whose grow passed a shadow compare
        self.verified_iteration = 0
        # the newest committed grow, for the boundary check:
        # (it_global, host tree, run_shadow)
        self._pending: Optional[Tuple[int, Any, Callable]] = None

    def should_check(self, it_global: int) -> bool:
        """Whether iteration ``it_global`` (0-based) is a shadow-compare
        iteration."""
        return self.freq > 0 and (it_global + 1) % self.freq == 0

    def fetch(self, model, site: str, primary=None, flag=None, shadow=None):
        """One host fetch (``model._fetch`` under ``site``) of the primary
        tree buffer, the B17a flag and the shadow's tree buffer, each
        optional.  Returns (primary host tree, flag ok, shadow host tree),
        None for what was not given."""
        parts = [t for t in (primary, flag, shadow) if t is not None]
        host = model._fetch(torch.cat([t.reshape(-1) for t in parts]), site)
        L, B, cb = self.layout
        out, off = [], 0
        for t, kind in ((primary, "tree"), (flag, "flag"),
                        (shadow, "tree")):
            if t is None:
                out.append(None)
                continue
            w = host[off:off + t.numel()]
            off += t.numel()
            out.append(bool(w[0]) if kind == "flag" else
                       host_tree(w, L, B, cat_bins=cb))
        return tuple(out)

    # -- grow-path verification ------------------------------------------

    def verify_grow(self, model, it_global: int, grow: Callable,
                    run_shadow: Callable, host_small, inv_ok: bool,
                    shadow_host):
        """Called right after the iteration's integrity fetch with the
        B17a flag and, on check iterations, the shadow's tree.  ``grow()``
        grows the primary again into its workspace (injection sites
        included) and returns (tree buffer, B17a flag); ``run_shadow()``
        grows the shadow again and returns its tree buffer.  Returns the
        host tree to commit: the original on a clean check, the re-run's
        on an absorbed transient (whose tree is then the primary
        workspace's).  Raises :class:`IntegrityFailure` on a sticky
        mismatch."""
        div: List[Dict[str, Any]] = []
        if shadow_host is not None:
            self.checks += 1
            _metrics().counter("integrity.checks", path="grow").inc()
            div = compare_tree_arrays(host_small, shadow_host, self.ulp_tol)
        if inv_ok and not div:
            if shadow_host is not None:
                self.verified_iteration = it_global + 1
            self._pending = (it_global, host_small, run_shadow)
            return host_small
        self._mismatch(it_global, inv_ok, div)
        # re-check once, fresh primary and fresh shadow (the injection
        # counters advance, so a single-hit transient is clean here)
        tree2, flag2 = grow()
        h2, inv2_ok, sh2 = self.fetch(model, "integrity_recheck", tree2,
                                      flag2, run_shadow())
        div2 = compare_tree_arrays(h2, sh2, self.ulp_tol)
        if inv2_ok and not div2:
            self._absorb(it_global)
            self._pending = (it_global, h2, run_shadow)
            return h2
        self._sticky(it_global, div2 or div, tree2)

    def _mismatch(self, it_global: int, inv_ok: bool,
                  div: List[Dict[str, Any]]) -> None:
        _metrics().counter("integrity.mismatches", path="grow").inc()
        Log.warning(
            f"integrity: mismatch at iteration {it_global + 1} "
            f"(invariants {'ok' if inv_ok else 'TRIPPED'}, "
            f"{len(div)} divergent field(s): "
            f"{[d['field'] for d in div]}); re-checking once")

    def _absorb(self, it_global: int) -> None:
        self.transients += 1
        _metrics().counter("integrity.transient_absorbed").inc()
        self.verified_iteration = it_global + 1
        Log.warning(
            f"integrity: iteration {it_global + 1} re-check clean — "
            "transient SDC absorbed (re-run result committed)")

    def _sticky(self, it_global: int, div: List[Dict[str, Any]],
                placed) -> None:
        """Terminal: record, attribute, (maybe) quarantine, raise."""
        _metrics().counter("integrity.sticky").inc()
        ids = attribute_devices(placed)
        fail = IntegrityFailure(
            detail=f"sticky SDC at iteration {it_global + 1}: "
                   f"{len(div)} divergent field(s) "
                   f"{[d['field'] for d in div][:4]}, "
                   f"suspect devices {ids}",
            iteration=it_global + 1, devices=tuple(ids),
            divergences=tuple(div[:8]))
        _on_failure(fail, site="integrity")
        if self.policy == "quarantine" and ids:
            mark_suspect(ids)
            _metrics().counter("integrity.quarantined").inc()
            Log.warning(f"integrity: quarantined device(s) {ids}")
        raise fail

    # -- score-path verification -----------------------------------------

    def verify_score(self, model, lv: torch.Tensor,
                     leaf_of_row: torch.Tensor, delta: torch.Tensor,
                     it_global: int) -> torch.Tensor:
        """On check iterations: re-gather ``lv[leaf_of_row]`` by B17b and
        compare it with the score update's ``delta`` on the device, one
        int32 fetch.  Returns the delta to add: ``delta``, or on an
        absorbed transient the primary gather taken again.  Same
        transient/sticky ladder as the grow path."""
        self.checks += 1
        _metrics().counter("integrity.checks", path="score").inc()
        bad = model._fetch(score_mismatch(lv, leaf_of_row, delta),
                           "integrity_score")
        if not bool(bad[0]):
            return delta
        _metrics().counter("integrity.mismatches", path="score").inc()
        Log.warning(
            f"integrity: score-update mismatch at iteration "
            f"{it_global + 1}; re-checking once")
        d2 = lv.index_select(0, leaf_of_row)
        if faultinject.enabled():
            faultinject.maybe_bitflip("score_sdc", d2)
        bad2 = model._fetch(score_mismatch(lv, leaf_of_row, d2),
                            "integrity_recheck")
        if not bool(bad2[0]):
            self.transients += 1
            _metrics().counter("integrity.transient_absorbed").inc()
            Log.warning(
                f"integrity: score re-check at iteration "
                f"{it_global + 1} clean — transient SDC absorbed")
            return d2
        self._sticky(it_global,
                     [{"field": "score_delta", "count": -1, "index": -1,
                       "got": 0.0, "want": 0.0, "ulp": -1}], delta)

    # -- snapshot-boundary check and manifest stamp ----------------------

    def boundary_check(self, model) -> None:
        """Shadow-verify the newest committed grow right before a snapshot
        is written (ROADMAP A12 calls it), so that a manifest's stamp means
        'last check clean at this snapshot'.  Re-runs only the shadow
        against the retained primary tree (it consumes no injection hits;
        a boundary on a just-checked iteration is free).  A mismatch here
        is sticky: one shadow re-run separates a shadow-side transient,
        then :class:`IntegrityFailure`.  The retained shadow run reads the
        iteration's operands, so it is valid until the next iteration."""
        if self._pending is None:
            return
        it_g, host_small, run_shadow = self._pending
        if self.verified_iteration >= it_g + 1:
            return
        self.checks += 1
        _metrics().counter("integrity.checks", path="boundary").inc()
        div: List[Dict[str, Any]] = []
        shadow = None
        for attempt in range(2):
            shadow = run_shadow()
            _, _, sh = self.fetch(model, "integrity_boundary",
                                  shadow=shadow)
            div = compare_tree_arrays(host_small, sh, self.ulp_tol)
            if not div:
                self.verified_iteration = it_g + 1
                return
            if attempt == 0:
                self._mismatch(it_g, True, div)
        self._sticky(it_g, div, shadow)

    def manifest(self, iteration: int) -> Dict[str, Any]:
        """The snapshot manifest's ``integrity`` stamp (ROADMAP A12 writes
        it): ``verified`` when the snapshot's newest tree passed a shadow
        compare."""
        return {
            "verified": bool(self.verified_iteration >= int(iteration)),
            "checked_iteration": int(self.verified_iteration),
            "checks": int(self.checks),
            "transients": int(self.transients),
            "check_freq": int(self.freq),
            "independent_trace": bool(self.independent),
        }
