"""lightgbm_torch: the PyTorch/CUDA port of lightgbm_tpu.

The same public surface as the JAX package (``Dataset``, ``train``,
``Booster``, the callbacks) and the same model text, with the device work
in hand-written CUDA kernels for Hopper (``csrc/``): B1 histogram, B2 split
scan, B3 row partition, B3s split step, B4 tree score update and B12
traced metrics, each beside its plain PyTorch version.  ``train`` takes
the JAX package's default paths (super-epochs and fused chunks, as CUDA
graph replays) or its per-iteration loop.  Training runs on the CUDA card
unless the caller passes ``device_type="cpu"``; then every kernel runs as
its plain version.
"""

__version__ = "0.1.0"

from .basic import LightGBMError
from .binning import BinMapper, BinType, MissingType
from .booster import Booster
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .dataset import Dataset, Sequence
from .engine import train
from .utils.log import register_logger

__all__ = [
    "BinMapper", "BinType", "MissingType", "Booster", "Config", "Dataset",
    "EarlyStopException", "LightGBMError", "Sequence", "early_stopping",
    "log_evaluation", "record_evaluation", "reset_parameter", "train",
    "register_logger",
]
