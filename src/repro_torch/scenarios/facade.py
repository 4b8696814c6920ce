"""Hybrid/active learning runs by workload name.

Port of the ``engine="simfast"`` branch of ``src/repro/scenarios/
facade.py::run_learning``: the dataset is built from the workload's spec
unless matrices are passed (Gaussian features, or with ``features.kind=
"lm"`` a synthetic text corpus encoded through the spec's LM,
:func:`repro_torch.embed.bank.make_dataset`), the learner kind sets the
round's active / passive split, and the batch engine's learning loop runs
it.
"""
from __future__ import annotations

from repro_torch.core.simfast import simulate_learning, simulate_learning_batch
from repro_torch.data.datasets import make_classification, train_test_split
from repro_torch.device import resolve_device
from repro_torch.embed.bank import make_dataset
from repro_torch.scenarios.registry import get_fast_config, get_learning_spec


def _k_active(spec, pool_size: int) -> int:
    # the learner kind as the active/passive split of each pool-sized
    # round: PL buys only random points, AL only uncertainty-sampled ones,
    # HL the al_fraction mix (pool // 2 at the default 0.5, as the engine's
    # own default, so odd pool sizes match it)
    if spec.kind == "PL":
        return 0
    if spec.kind == "AL":
        return pool_size
    if spec.kind == "HL":
        return pool_size // 2 if spec.al_fraction == 0.5 \
            else int(round(spec.al_fraction * pool_size))
    raise ValueError(f"run_learning cannot express learner kind "
                     f"{spec.kind!r}")


def spec_dataset(name: str, n_train: int = 1500, n_test: int = 500,
                 seed: int = 0, overrides: dict = None):
    """The named workload's Gaussian dataset as :func:`run_learning` builds
    it: ``make_classification`` with the spec's width and separation and
    ``n_informative = min(n_features, max(2, n_classes))``, split
    ``n_train``/``n_test``. Returns numpy ``(X, y, X_test, y_test)``."""
    spec = get_learning_spec(name, overrides)
    Xa, ya = make_classification(
        n_samples=n_train + n_test, n_features=spec.n_features,
        n_informative=min(spec.n_features, max(2, spec.n_classes)),
        n_classes=spec.n_classes, class_sep=spec.class_sep, seed=seed)
    return train_test_split(Xa, ya, test_frac=n_test / (n_train + n_test),
                            seed=seed)


def run_learning(name: str, X=None, y=None, X_test=None, y_test=None, *,
                 vectorized: bool = True, rounds: int = 10, n_reps: int = 64,
                 seed: int = 0, fit_steps: int = 60, k_active=None,
                 use_kernel: bool = True, accest=None, n_train: int = 1500,
                 n_test: int = 500, device="cuda", draws=None,
                 overrides: dict = None, embed_draws: dict = None):
    """Hybrid learning on the named workload.

    ``overrides`` takes the reference's dotted keys (see
    :func:`~repro_torch.scenarios.registry.get_learning_spec`). With
    ``X=None`` the dataset is built from the spec, seeded with ``seed``:
    :func:`spec_dataset` for Gaussian features, or for ``features.kind=
    "lm"`` :func:`~repro_torch.embed.bank.make_dataset` on ``device``, with
    ``embed_draws`` (its ``u``/``ul``/``params``/``proj``) replacing its
    draws. Otherwise pass all of ``X``/``y``/``X_test``/``y_test``.
    ``vectorized`` runs
    :func:`~repro_torch.core.simfast.simulate_learning_batch` over
    ``n_reps`` replications, else the scalar
    :func:`~repro_torch.core.simfast.simulate_learning` (with ``accest``).
    Returns the engine's result with the config.
    """
    dev = resolve_device(device)
    cfg = get_fast_config(name)
    spec = get_learning_spec(name, overrides)
    if X is None:
        if y is not None or X_test is not None or y_test is not None:
            raise ValueError("run_learning: pass all of X/y/X_test/y_test "
                             "or none (spec-built dataset)")
        if spec.feature_kind == "lm":
            X, y, X_test, y_test = make_dataset(
                spec, n_train, n_test, seed=seed, device=dev,
                **(embed_draws or {}))
        else:
            X, y, X_test, y_test = spec_dataset(name, n_train, n_test, seed,
                                                overrides)
    elif y is None or X_test is None or y_test is None:
        raise ValueError("run_learning: pass all of X/y/X_test/y_test "
                         "or none (spec-built dataset)")
    if k_active is None:
        k_active = _k_active(spec, cfg.pool_size)
    kw = dict(rounds=rounds, seed=seed, fit_steps=fit_steps,
              k_active=k_active, use_kernel=use_kernel,
              decision_latency_s=spec.decision_latency_s, device=dev,
              draws=draws)
    if vectorized:
        raw = simulate_learning_batch(cfg, X, y, X_test, y_test,
                                      n_reps=n_reps, **kw)
        return dict(engine="simfast", scenario=name, config=cfg, raw=raw,
                    curve=raw["curve"])
    curve, info = simulate_learning(cfg, X, y, X_test, y_test, accest=accest,
                                    **kw)
    return dict(engine="simfast", scenario=name, config=cfg, curve=curve,
                raw=info)
