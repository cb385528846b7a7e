"""Policy networks and action distributions.

The MLP policy and the distributions are plain JAX.  The transformer
(:mod:`.gpt`), the decision transformer (:mod:`.dt`) and the hypernetwork
layers (:mod:`.hyper_mlp`) need the ``flax`` extra and are imported on
first use of their names.
"""

from .truncated_normal import TruncatedNormal
from . import bbox_dist
from .gpt_config import GPTConfig
from .mlp import (
    FCPolicy,
    multi_categorical_sample, multi_categorical_log_prob,
    multi_categorical_entropy,
)

_FLAX_NAMES = {"GPTPolicy": "gpt", "WLinear": "hyper_mlp",
               "HyperMLP": "hyper_mlp"}


def __getattr__(name):
    if name in _FLAX_NAMES:
        import importlib
        mod = importlib.import_module(f".{_FLAX_NAMES[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "TruncatedNormal", "bbox_dist", "GPTPolicy", "GPTConfig",
    "FCPolicy", "WLinear", "HyperMLP",
    "multi_categorical_sample", "multi_categorical_log_prob",
    "multi_categorical_entropy",
]
