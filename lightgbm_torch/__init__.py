"""lightgbm_torch: the PyTorch/CUDA port of lightgbm_tpu.

The same public surface as the JAX package (``Dataset``, ``train``,
``Booster``, the callbacks) and the same model text, with the device work
in hand-written CUDA kernels for Hopper (``csrc/``): B1 histogram, B2 split
scan, B3 row partition, B3s split step, B4 tree score update, B10 forest
walk, device binning and fused forest predict, and B12 traced metrics,
each beside its plain PyTorch version.  ``train`` takes the JAX package's
default paths (super-epochs and fused chunks, as CUDA graph replays) or
its per-iteration loop; ``Booster.predict`` takes the predictor engine's
device walk for large inputs, and ``serve.Server`` serves a model with
micro-batching, hot swap, a circuit breaker and an HTTP frontend.
Training, prediction and serving run on the CUDA card unless the caller
passes ``device_type="cpu"``; then every kernel runs as its plain version.
``tree_learner=data|feature|voting`` trains over ``torch.distributed``, one
process per rank (``parallel/``, ``distributed.py``).
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
from .serve import PredictorEngine, Server
from .utils.log import register_logger

__all__ = [
    "BinMapper", "BinType", "MissingType", "Booster", "Config", "Dataset",
    "EarlyStopException", "LightGBMError", "PredictorEngine", "Sequence",
    "Server", "early_stopping",
    "log_evaluation", "record_evaluation", "reset_parameter", "train",
    "register_logger",
]
