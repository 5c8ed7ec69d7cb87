"""Bridges from the JAX package's state into the port's records.

A GBDT carries no weight tensors: its state is the bin mappers and the
trees.  ``tree_arrays_from_numpy`` takes the fields of the JAX package's
``TreeArrays`` as fetched with ``np.asarray``, and ``dataset_from_numpy``
the binned matrix and bin metadata, so that one reference tree can be fed
to both packages' kernels.  The model text is the other bridge:
``Booster(model_str=...)`` loads the JAX package's ``model_to_string()``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .grower import TreeArrays


def tree_arrays_from_numpy(d: Dict[str, np.ndarray],
                           device="cpu") -> TreeArrays:
    """TreeArrays from the JAX package's fields (numerical nodes only).
    ``leaf_of_row`` goes to ``device``; tree-sized fields stay on the host
    and are sliced to the tree's own budget when the JAX grower padded
    its leaf axis."""
    nl = int(np.asarray(d["num_leaves"]))
    is_cat = np.asarray(d["is_cat_node"], bool)
    if is_cat[:max(nl - 1, 0)].any():
        raise NotImplementedError(
            "categorical tree nodes are not ported to lightgbm_torch yet "
            "(ROADMAP A9)")
    node = {k: np.asarray(d[k]) for k in (
        "split_feature", "threshold_bin", "default_left", "left_child",
        "right_child", "split_gain", "internal_value", "internal_weight",
        "internal_count", "is_cat_node", "cat_rank")}
    leaf = {k: np.asarray(d[k]) for k in (
        "leaf_value", "leaf_weight", "leaf_count", "leaf_depth")}
    return TreeArrays(
        num_leaves=nl,
        split_feature=node["split_feature"].astype(np.int32),
        threshold_bin=node["threshold_bin"].astype(np.int32),
        default_left=node["default_left"].astype(bool),
        left_child=node["left_child"].astype(np.int32),
        right_child=node["right_child"].astype(np.int32),
        split_gain=node["split_gain"].astype(np.float32),
        leaf_value=leaf["leaf_value"].astype(np.float32),
        leaf_weight=leaf["leaf_weight"].astype(np.float32),
        leaf_count=leaf["leaf_count"].astype(np.float32),
        internal_value=node["internal_value"].astype(np.float32),
        internal_weight=node["internal_weight"].astype(np.float32),
        internal_count=node["internal_count"].astype(np.float32),
        leaf_depth=leaf["leaf_depth"].astype(np.int32),
        leaf_of_row=torch.as_tensor(
            np.array(d["leaf_of_row"], np.int32)).to(device),
        is_cat_node=node["is_cat_node"].astype(bool),
        cat_rank=node["cat_rank"].astype(np.int32),
        n_steps=int(np.asarray(d.get("n_steps", nl - 1))))


class BinnedData(NamedTuple):
    """The binned matrix and bin metadata the kernels consume."""
    binned: torch.Tensor              # [N, F] uint8
    num_bin: torch.Tensor             # [F] int32
    na_bin: torch.Tensor              # [F] int32 (-1 = no NA bin)
    bin_upper_bounds: List[np.ndarray]


def dataset_from_numpy(binned: np.ndarray, num_bin: np.ndarray,
                       na_bin: np.ndarray, bin_upper_bounds,
                       device="cpu") -> BinnedData:
    """Device tensors of a binned dataset (for example the JAX package's
    ``Dataset.binned`` and its bin mappers' ``num_bin``, ``na_bin`` and
    ``bin_upper_bound``)."""
    binned = np.ascontiguousarray(binned)
    if binned.dtype != np.uint8:
        raise NotImplementedError(
            "more than 256 bins per feature is not ported to lightgbm_torch "
            "yet (ROADMAP A9)")
    return BinnedData(
        binned=torch.as_tensor(binned).to(device),
        num_bin=torch.as_tensor(np.asarray(num_bin, np.int32)).to(device),
        na_bin=torch.as_tensor(np.asarray(na_bin, np.int32)).to(device),
        bin_upper_bounds=[np.asarray(u, np.float64)
                          for u in bin_upper_bounds])
