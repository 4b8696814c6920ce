"""learning: the hybrid/active learning subsystem of the port.

Port of ``src/repro/learning`` (without ``compat.LogisticLearner``, which
serves the event loop): the batched :class:`~repro_torch.learning.linear.
LinearLearner` with its masked Adam ``fit`` and ``entropy`` on the Hopper
entropy kernel, uncertainty/passive/hybrid point selection with index
tie-breaking (``select``), budget allocation (``allocate``) and feature
standardization (``features``). Exports resolve lazily, as in the reference
package.
"""
import importlib

_EXPORTS = {
    "LinearLearner": "linear",
    "init": "linear",
    "reset_opt": "linear",
    "from_numpy": "linear",
    "fit": "linear",
    "fit_step": "linear",
    "logits": "linear",
    "predict": "linear",
    "predict_proba": "linear",
    "entropy": "linear",
    "entropy_from_logits": "linear",
    "test_accuracy": "linear",
    "standardize": "features",
    "topk_uncertain": "select",
    "al_select": "select",
    "passive_select": "select",
    "hybrid_select": "select",
    "split_budget": "allocate",
    "AccEst": "allocate",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
