"""Shared inputs for the lightgbm_torch parity tests (tests/test_torch_*).

Every input is made with numpy from a seed and handed to both packages:
the JAX package (the reference, run on the CPU) and its PyTorch port
(``device_type="cpu"``, where every kernel runs as its plain version).
"""

import numpy as np


def binned_problem(seed: int, n: int = 4000, f: int = 8, bins: int = 31,
                   na_features=(2, 5)):
    """A binned matrix with well separated signal, per-row (g, h, 1) vals
    and bin metadata.  Features in ``na_features`` carry an NA bin (the
    last bin, as BinMapper gives NaN values)."""
    rs = np.random.RandomState(seed)
    binned = rs.randint(0, bins - 1, size=(n, f)).astype(np.uint8)
    num_bin = np.full(f, bins - 1, np.int32)
    na_bin = np.full(f, -1, np.int32)
    for j in (j for j in na_features if j < f):
        num_bin[j] = bins
        na_bin[j] = bins - 1
        nan_rows = rs.rand(n) < 0.15
        binned[nan_rows, j] = bins - 1
    # steps of decreasing size on several features: every split of a
    # small tree follows real structure, so gains are well separated
    steps = [(0, bins // 2, 3.0), (1, bins // 3, -2.0), (3, 2 * bins // 3, 1.3),
             (4, bins // 4, -0.9), (1, 2 * bins // 3, 0.6)]
    signal = 0.05 * rs.randn(n).astype(np.float32)
    for j, cut, size in steps:
        if j < f:
            signal += size * (binned[:, j] >= cut).astype(np.float32)
    if f > 2:
        signal += 1.6 * (binned[:, 2] == bins - 1)
    g = (0.4 - signal).astype(np.float32)
    h = (0.5 + 0.5 * rs.rand(n)).astype(np.float32)
    vals = np.stack([g, h, np.ones(n, np.float32)], axis=1)
    return binned, vals, num_bin, na_bin


def raw_problem(seed: int, n: int = 3000, f: int = 8, task: str = "binary",
                nan_frac: float = 0.05):
    """Raw features with NaNs and a binary or regression target with a
    clear signal, so split gains are well separated."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f)
    logit = 1.5 * x[:, 0] - x[:, 1] + 0.8 * x[:, 2] * x[:, 3] \
        + 0.5 * rs.randn(n)
    x[rs.rand(n, f) < nan_frac] = np.nan
    if task == "binary":
        y = (logit > 0).astype(np.float32)
    else:
        y = (2.0 * logit + 0.3 * rs.randn(n)).astype(np.float32)
    return x, y
