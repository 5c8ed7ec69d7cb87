"""Versioned model registry with atomic hot swap (the JAX package's
``serve/registry.py``).

Serving must outlive any single model file: the registry holds
(version -> :class:`ServedModel`) where each entry pairs a loaded
``Booster`` with its :class:`~.engine.PredictorEngine`, and an atomic
"current" pointer.  ``activate`` swaps the pointer under a lock — a
reader that already resolved :meth:`current` keeps its handle, so
in-flight requests finish on the version they started on while new
requests pick up the swap.

Models load from model files / strings / live Boosters.  Artifacts are
VERIFIED before activation: a load pinned to ``expected_sha256`` checks
the artifact's bytes (:class:`ArtifactVerificationError` on mismatch —
the current version keeps serving), and with ``verify_artifacts`` a
freshly built engine must pass its byte-parity ``self_check`` probe or
serving falls back to the host walk.  A self-check that cannot RUN
counts as failed, except for a kernel that does not build or launch:
that raises (``_kernels.is_kernel_fault``), so a broken kernel is never
mistaken for a model the host walk should serve.  A failed ``load`` of
any kind leaves the registry untouched.  ``load_snapshot`` needs the
training snapshots of ``snapshot.py`` (ROADMAP A12).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional

from .. import _kernels
from ..booster import Booster
from ..utils.log import Log
from .engine import EngineUnsupported, PredictorEngine


def _sha256_hex(data) -> str:
    """SHA-256 of ``data`` (str encoded as UTF-8)."""
    if isinstance(data, str):
        data = data.encode()
    return hashlib.sha256(data).hexdigest()


class NoModelError(RuntimeError):
    """The registry has no active model."""


class ArtifactVerificationError(RuntimeError):
    """A model artifact failed checksum verification — refused, never
    activated (the current version keeps serving)."""


class ServedModel:
    """One immutable (version, booster, engine) serving unit.

    Carries an IN-FLIGHT request counter (``begin_request`` /
    ``end_request``, bracketed around every batch the server runs on
    this version): the residency-cap eviction skips versions with
    requests in flight.  This is residency ACCOUNTING, not a
    use-after-free guard — the batch's own reference keeps the model
    alive regardless; the counter keeps a mid-batch version registered
    (addressable, its device tables resident) so a swap back to it
    never pays a re-upload the cap bookkeeping thought it had
    reclaimed.  ``self_check_failed`` records
    that the engine's byte-parity probe FAILED at load (as opposed to
    the engine being unsupported) — the continual promotion gate refuses
    such candidates outright where plain serving merely demotes them to
    the host walk.

    Lock contract: ``_iflock`` guards ``_inflight``.  Everything else on a ServedModel is immutable after registration
    (``registry.load`` publishes it under the registry lock)."""

    __slots__ = ("version", "booster", "engine", "source", "loaded_at",
                 "self_check_failed", "sha256", "_inflight", "_iflock")

    def __init__(self, version: str, booster, engine, source: str):
        self.version = version
        self.booster = booster
        self.engine = engine
        self.source = source
        self.loaded_at = time.time()
        self.self_check_failed = False
        # the verified artifact checksum this version was loaded under
        # (None for live boosters / unpinned loads) — the continual
        # gate uses it to decide whether the serving incumbent IS the
        # snapshot a candidate boosted from (lineage applicability)
        self.sha256: "str | None" = None
        self._inflight = 0
        self._iflock = threading.Lock()

    def begin_request(self) -> None:
        with self._iflock:
            self._inflight += 1

    def end_request(self) -> None:
        with self._iflock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        # locked read: a torn read is impossible for a GIL int, but the
        # registry's eviction decision ("may I drop this version?")
        # must observe a count that is current with respect to a
        # concurrent begin_request, not a stale register
        with self._iflock:
            return self._inflight

    def describe(self) -> dict:
        return {"version": self.version, "source": self.source,
                "loaded_at": self.loaded_at,
                "num_trees": len(self.booster.trees),
                "num_class": self.booster._num_tree_per_iteration,
                "num_features": self.booster.num_feature(),
                "inflight": self.inflight,
                "fingerprint": self.engine.fingerprint
                if self.engine is not None else None}


class ModelRegistry:
    """Versioned (version -> ServedModel) map with an atomic current
    pointer (module docstring).

    Lock contract: ``_lock`` guards ``_models``, ``_current`` and
    ``_next_version``.  ``_lock`` is leaf-level except for ``ServedModel._iflock``: the
    eviction scan reads ``inflight`` (which takes ``_iflock``) while
    holding ``_lock`` — that order (registry then model) is the ONLY
    sanctioned nesting; ServedModel methods never call back into the
    registry."""

    def __init__(self, *, max_batch: Optional[int] = None,
                 min_bucket: int = 16,
                 verify_artifacts: bool = True,
                 device_binning: bool = False, packed: bool = True,
                 max_resident: int = 0, device_type: str = "cuda"):
        self._models: Dict[str, ServedModel] = {}
        self._current: Optional[ServedModel] = None
        self._lock = threading.Lock()
        self._next_version = 1
        self._engine_opts = {"max_batch": max_batch,
                             "min_bucket": min_bucket, "packed": packed,
                             "device_type": device_type}
        # loaded models predict on the registry's device too
        self._device_type = device_type
        self._verify = verify_artifacts
        # the server will serve via the f32 device-binning path
        # (serve_device_binning): self-checks must verify THAT path,
        # not just the host-binned one
        self._device_binning = device_binning
        # co-hosting cap (serve_max_resident): every registered version
        # keeps its engine — packed SoA tables — device-resident, so a
        # swap back to it needs no re-upload.  Past the cap,
        # loading evicts the oldest non-current version; the current
        # version and the load in hand are never candidates, so a
        # shadow load can exceed the cap by ONE until the next load or
        # swap (refusing it would be worse than a transient +1).
        # 0 = unlimited
        self._max_resident = max(0, int(max_resident))

    # -- loading -----------------------------------------------------------
    def load(self, model_file: Optional[str] = None,
             model_str: Optional[str] = None, booster=None,
             version: Optional[str] = None, source: str = "",
             activate: bool = True,
             expected_sha256: Optional[str] = None) -> str:
        """Load one model (exactly one of file / string / booster),
        register it, and (by default) atomically make it current.

        Verification: with ``expected_sha256`` set, the model file's bytes must hash to it
        or the load raises :class:`ArtifactVerificationError` before
        anything is registered — a truncated, bit-rotted or
        wrong-version artifact can never be swapped in.  A freshly
        built engine must additionally pass its byte-parity
        ``self_check`` probe against the host tree walk, or it is
        discarded in favor of the (always-correct) host walk."""
        if sum(a is not None
               for a in (model_file, model_str, booster)) != 1:
            raise ValueError("load needs exactly one of model_file, "
                             "model_str, booster")
        if booster is not None and expected_sha256 is not None:
            # a live Booster has no byte artifact to hash — accepting
            # the pin silently would fake verification
            raise ValueError("expected_sha256 requires model_file or "
                             "model_str, not a live booster")
        if expected_sha256 is not None and not expected_sha256:
            # an empty pin is an unset variable in the caller's deploy
            # script, not a request to skip verification — falling
            # through to the unverified branch would fake enforcement
            raise ValueError("expected_sha256 must be a non-empty "
                             "SHA-256 hex digest (got '')")
        if booster is None:
            if expected_sha256:
                # an EXPLICIT pin is always enforced — verify_artifacts
                # gates only the automatic checks (snapshot-manifest
                # checksums, engine self-check); skipping a pin the
                # caller spelled out would fake verification.  A pinned
                # file is read ONCE: the bytes that hashed clean are the
                # bytes that get parsed, so a file swapped on disk after
                # the hash can never be activated unverified.
                if model_file is not None:
                    with open(model_file, "rb") as f:
                        data = f.read()
                    got = _sha256_hex(data)
                else:
                    got = _sha256_hex(model_str)
                if got != expected_sha256:
                    raise ArtifactVerificationError(
                        f"model artifact "
                        f"{model_file or '<model_str>'} checksum "
                        f"mismatch (got {got[:12]}…, expected "
                        f"{expected_sha256[:12]}…); refusing to load")
                if model_file is not None:
                    model_str = data.decode("utf-8")
                booster = Booster(
                    params={"device_type": self._device_type},
                    model_str=model_str)
            else:
                booster = Booster(
                    params={"device_type": self._device_type},
                    model_file=model_file, model_str=model_str)
            source = source or (model_file or "<model_str>")
        else:
            source = source or "<booster>"
        engine = None
        self_check_failed = False
        try:
            engine = PredictorEngine.from_booster(booster,
                                                  **self._engine_opts)
            if self._verify:
                try:
                    ok = engine.self_check(
                        device_binning=self._device_binning)
                except Exception as e:  # noqa: BLE001 — a probe
                    # that cannot RUN (device blip during reload)
                    # must not fail a load the host walk can serve;
                    # a kernel that does not build or launch is no
                    # blip, and raises
                    if _kernels.is_kernel_fault(e):
                        raise
                    Log.warning(f"serve: engine self-check errored "
                                f"for {source} ({e}); treating as "
                                "failed")
                    ok = False
                if not ok:
                    # the compiled artifact disagrees with the
                    # model it came from (or could not be proven):
                    # never serve it — the host walk is the oracle
                    # the parity tests trust, fall back to it
                    Log.warning(
                        f"serve: engine self-check FAILED for "
                        f"{source}; discarding engine, serving via "
                        "host walk")
                    engine = None
                    self_check_failed = True
                    booster._engine_cache = False
        except EngineUnsupported as e:
            # an engine-unsupported model is still SERVABLE — the
            # batch path falls back to the host walk exactly like
            # Booster.predict does; only the bucketed cache is lost
            Log.warning(f"serve: bucketed engine unavailable for "
                        f"{source} ({e}); serving via host walk")
            booster._engine_cache = False
        else:
            # make this THE booster's predictor too: Booster.predict
            # on the serve path then rides the same engine, and its
            # bucket ledger (surfaced via /metrics) sees every batch
            if engine is not None:
                booster._engine_cache = engine
        with self._lock:
            if version is None:
                version = f"v{self._next_version}"
            self._next_version += 1
            if version in self._models:
                raise ValueError(f"model version {version!r} already "
                                 "registered")
            served = ServedModel(version, booster, engine, source)
            served.self_check_failed = self_check_failed
            served.sha256 = expected_sha256 or None
            self._models[version] = served
            if activate:
                # an explicit shadow load (activate=False) NEVER takes
                # traffic — not even into an empty registry: the gated
                # promotion relies on a refused candidate having served
                # zero requests, and an auto-activated shadow would
                # serve during the gate window (model-less registries
                # answer NoModelError until something activates)
                self._current = served
            if self._max_resident > 0:
                # evict oldest non-current versions past the residency
                # cap — the bound on co-hosted device memory.  The
                # just-registered version is never an eviction
                # candidate: a shadow load (activate=False) at the cap
                # must displace an OLDER version, not itself.  Versions
                # with requests IN FLIGHT are skipped too — a batch that
                # resolved its handle must finish on the tables it is
                # traversing; such versions exceed the cap transiently
                # and become evictable at the next load
                others = sorted(
                    (m for m in self._models.values()
                     if m is not self._current and m is not served
                     and m.inflight == 0),
                    key=lambda m: m.loaded_at)
                while len(self._models) > self._max_resident and others:
                    self._models.pop(others.pop(0).version, None)
        return version

    def load_snapshot(self, output_model: str,
                      version: Optional[str] = None,
                      activate: bool = True,
                      expected_sha256: Optional[str] = None) -> str:
        """Load the newest complete training snapshot of
        ``output_model``: needs ``snapshot.py``, not ported yet."""
        raise NotImplementedError(
            "serving from training snapshots needs snapshot.py, which is "
            "not ported to lightgbm_torch yet (ROADMAP A12)")

    @property
    def max_resident(self) -> int:
        """The co-hosting residency cap (0 = unlimited)."""
        return self._max_resident

    # -- swap / lookup -----------------------------------------------------
    def activate(self, version: str) -> None:
        """Atomically point new requests at ``version``; handles already
        resolved via :meth:`current` are unaffected."""
        with self._lock:
            if version not in self._models:
                raise KeyError(f"unknown model version {version!r}")
            self._current = self._models[version]

    def current(self) -> ServedModel:
        with self._lock:
            if self._current is None:
                raise NoModelError("no model loaded")
            return self._current

    def get(self, version: Optional[str] = None) -> ServedModel:
        if version is None:
            return self.current()
        with self._lock:
            try:
                return self._models[version]
            except KeyError:
                raise KeyError(f"unknown model version {version!r}") \
                    from None

    def unload(self, version: str, force: bool = False) -> None:
        """Drop a non-current version (the current one must be swapped
        away first — unloading what is serving would strand the next
        request with no model).  ``force=True`` expels even the current
        version, returning the registry to model-less; it exists as the
        gated-promotion rollback's belt-and-braces (shadow loads never
        auto-activate, so in normal operation a refused candidate is
        never current — force covers operator surgery and defensive
        rollback paths only)."""
        with self._lock:
            if self._current is not None \
                    and self._current.version == version:
                if not force:
                    raise ValueError("cannot unload the current "
                                     "version; activate another first")
                self._current = None
            self._models.pop(version, None)

    def versions(self) -> List[dict]:
        with self._lock:
            cur = self._current.version if self._current else None
            return [dict(m.describe(), current=(v == cur))
                    for v, m in sorted(self._models.items())]
