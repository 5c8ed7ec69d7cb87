"""Reference ``lightgbm.basic`` compatibility surface.

The reference python-package keeps its ctypes plumbing and shared
helpers in ``basic.py`` and its OWN tests (and a fair amount of
third-party code) import from there: ``LightGBMError``,
``list_to_1d_numpy``, ``_choose_param_value``, ``_ConfigAliases``,
``_data_from_pandas`` (basic.py:391, :340, :82 in the reference).  This
module provides those names re-implemented over this framework's config
table so ``import lightgbm_torch.basic as basic``-style code works
unmodified.  There is no ctypes plumbing for the training core here: it
is a PyTorch program (the CUDA kernels' own ctypes binding lives in
``_kernels.py``).
"""

from __future__ import annotations

import warnings
from copy import deepcopy
from typing import Any, Dict, Set

import numpy as np

__all__ = ["LightGBMError", "list_to_1d_numpy", "_choose_param_value",
           "_ConfigAliases", "_data_from_pandas"]


class LightGBMError(ValueError):
    """User-input error (basic.py LightGBMError).  Subclasses ValueError
    so callers catching the generic Python error keep working while
    reference-API code catching LightGBMError gets the exact type."""


def _is_1d_collection(data) -> bool:
    return (isinstance(data, (list, tuple))
            or (isinstance(data, np.ndarray) and data.ndim == 1))


def list_to_1d_numpy(data, dtype=np.float32, name: str = "list"):
    """Coerce a 1-d collection to a numpy array (basic.py list_to_1d_numpy
    contract): column-vector ndarrays are accepted with a warning, nested
    lists are a TypeError, object Series a ValueError."""
    if isinstance(data, np.ndarray):
        if data.ndim == 2:
            if data.shape[1] != 1:
                raise ValueError(f"{name} must be 1-dimensional")
            warnings.warn(
                f"Converting column-vector {name} to 1d array", UserWarning)
            data = data.ravel()
        return data.astype(dtype=dtype, copy=False)
    if isinstance(data, (list, tuple)):
        if len(data) and isinstance(data[0], (list, tuple, np.ndarray)):
            raise TypeError(f"{name} must be a flat collection, got nested")
        return np.asarray(data, dtype=dtype)
    # pandas Series (duck-typed: no hard pandas dependency)
    if hasattr(data, "dtype") and hasattr(data, "to_numpy"):
        if data.dtype == object:
            raise ValueError(f"{name} of object dtype is not supported")
        return data.to_numpy().astype(dtype=dtype, copy=False)
    raise TypeError(f"cannot convert {type(data).__name__} to 1d numpy "
                    f"array for {name}")


class _ConfigAliases:
    """Canonical-name -> alias-set table (the reference builds this by
    calling LGBM_DumpParamAliases into a JSON buffer, basic.py:344; here
    the config table IS the source)."""

    aliases: Dict[str, Set[str]] = None

    @classmethod
    def _build(cls) -> None:
        if cls.aliases is not None:
            return
        from .config import _PARAMS
        cls.aliases = {name: set(al) | {name}
                       for name, (_t, _d, al) in _PARAMS.items()}

    @classmethod
    def get(cls, *args: str) -> Set[str]:
        cls._build()
        out: Set[str] = set()
        for name in args:
            out |= cls.aliases.get(name, {name})
        return out


def _choose_param_value(main_param_name: str, params: Dict[str, Any],
                        default_value: Any) -> Dict[str, Any]:
    """One value for ``main_param_name`` with every alias removed; the
    canonical spelling wins over aliases — by PRESENCE, so an explicit
    ``None`` under the canonical key is preserved rather than overridden
    by an alias (the reference returns immediately when the main name is
    in params) — and aliases win over the default (basic.py:391
    contract)."""
    params = deepcopy(params)
    found_main = main_param_name in params
    found = params.get(main_param_name)
    for alias in _ConfigAliases.get(main_param_name):
        val = params.pop(alias, None)
        if not found_main and found is None and val is not None:
            found = val
    if found_main:
        params[main_param_name] = found
    else:
        params[main_param_name] = default_value if found is None else found
    return params


def _data_from_pandas(data, feature_name=None, categorical_feature=None,
                      pandas_categorical=None):
    """DataFrame -> (float ndarray, feature_name, categorical_feature,
    pandas_categorical) — the reference's pandas ingestion contract
    (basic.py _data_from_pandas), including the no-copy fast path when
    every column already shares one float dtype."""
    if not (hasattr(data, "columns") and hasattr(data, "dtypes")):
        raise ValueError("data should be a pandas DataFrame")
    if feature_name in (None, "auto"):
        feature_name = [str(c) for c in data.columns]
    dtypes = {str(dt) for dt in data.dtypes}
    if dtypes == {"float64"}:
        arr = data.to_numpy(dtype=np.float64, copy=False)
    elif dtypes == {"float32"}:
        arr = data.to_numpy(dtype=np.float32, copy=False)
    else:
        arr = data.astype(np.float64).to_numpy()
    return arr, feature_name, categorical_feature, pandas_categorical
