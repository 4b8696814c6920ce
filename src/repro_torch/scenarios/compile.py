"""Lower declarative specs to the port's engine configs (port of
``src/repro/scenarios/compile.py``).

  * :func:`to_fast_config`   -> ``repro_torch.core.simfast.FastConfig``
  * :func:`to_stream_config` -> ``repro_torch.labelstream.StreamConfig``
  * :func:`to_serve_config`  -> the same with ``serve=True``
  * :func:`to_embed_config`  -> ``repro_torch.embed.config.EmbedConfig``
  * :func:`to_cs_config`     -> ``repro_torch.core.clamshell.CSConfig``

Compilation is exact: every registry scenario lowers to the config the
reference's compiler gives, field for field. A spec that demands a policy
an engine cannot express raises ``ValueError`` naming the field, as in the
reference.
"""
from __future__ import annotations

import dataclasses

from repro_torch.scenarios.spec import ScenarioSpec

ENGINES = ("events", "simfast", "stream")

#: dotted spec paths each engine runs as per-cell values inside one batched
#: run (the batch engine's ``PopTraced``, the stream's ``StreamTraced``).
#: ``repro_torch.grid`` partitions grid cells into static-config classes by
#: overriding exactly these paths back to the base value before lowering
#: and hashing; the scalar events engine batches nothing.
TRACED_AXES = {
    "events": (),
    "simfast": ("pool.median_mu", "pool.session_mean_s",
                "pool.recruit_mean_s", "pool.cold_recruit_mean_s",
                "pool.acc_a", "pool.acc_b"),
    "stream": ("arrivals.rate", "policy.redundancy.votes",
               "pool.acc_a", "pool.acc_b",
               "difficulty.p_hard", "difficulty.hard_scale"),
}

# engine defaults the spec layer must not silently change
_FAST_DT = 2.0
_STREAM_DT = 5.0
_FAST_BANK = 16
_STREAM_BANK = 64


def engines(spec: ScenarioSpec) -> tuple:
    """Engines this scenario can run on, derived from the spec itself:
    a finite ``batch`` workload runs on the closed-world engines, an
    arrival process needs the streaming engine (which in turn requires a
    retainer pool)."""
    if spec.arrivals.kind == "batch":
        return ("events", "simfast")
    return ("stream",) if spec.pool.retainer else ()


def _reject(engine: str, field: str, why: str):
    raise ValueError(f"scenario cannot compile for engine {engine!r}: "
                     f"{field} {why}")


def _trace_config(spec: ScenarioSpec):
    """Lower ``spec.trace`` to the engines' TraceConfig (None = off, the
    untraced program)."""
    if not spec.trace.enabled:
        return None
    from repro_torch.obs.trace import TraceConfig
    return TraceConfig(phases=spec.trace.phases,
                       per_tick=spec.trace.per_tick)


def _check_batch_engine(spec: ScenarioSpec, engine: str):
    if spec.arrivals.kind != "batch":
        _reject(engine, "arrivals.kind",
                f"= {spec.arrivals.kind!r}; the closed-world engines replay "
                "a finite task set (use engine='stream')")
    if spec.pool.n_shards != 1:
        _reject(engine, "pool.n_shards",
                f"= {spec.pool.n_shards}; sharded pools are a stream-engine "
                "concept — a batch run would silently drop all but one "
                "shard's workers")
    pol = spec.policy
    if pol.redundancy.adaptive:
        _reject(engine, "policy.redundancy.adaptive",
                "= True; posterior-confidence adaptive redundancy is a "
                "stream-engine policy")
    if pol.routing.kind != "uniform":
        _reject(engine, "policy.routing.kind",
                f"= {pol.routing.kind!r}; worker-aware scored routing is a "
                "stream-engine policy")
    if pol.admission.kind != "fifo" or pol.admission.batch_replay:
        _reject(engine, "policy.admission",
                "!= default; backlog admission disciplines are stream-"
                "engine policies")
    if pol.learner.enabled:
        _reject(engine, "policy.learner.enabled",
                "= True; online learner fusion is a stream-engine policy "
                "(batch engines run hybrid learning via run_learning)")
    if spec.features.kind != "gaussian":
        _reject(engine, "features.kind",
                f"= {spec.features.kind!r}; the batch engines consume "
                "feature MATRICES, not in-tick feature draws — build an "
                "LM dataset with repro_torch.embed.bank.make_dataset (or "
                "let scenarios.run_learning build it) instead")
    if spec.difficulty.p_hard > 0:
        _reject(engine, "difficulty.p_hard",
                "> 0; the difficulty mixture is modeled by the stream "
                "engine only")
    sh = spec.sharding
    if sh.n_devices != 1 or sh.steal != "none":
        _reject(engine, "sharding",
                f"= ShardingSpec(n_devices={sh.n_devices}, "
                f"steal={sh.steal!r}); device-sharded ticks and cross-shard "
                "work stealing are stream-engine concepts (the batch "
                "engines pmap replications instead)")


def to_fast_config(spec: ScenarioSpec):
    """ScenarioSpec -> simfast.FastConfig (vectorized batch engine)."""
    from repro_torch.core.simfast import FastConfig

    _check_batch_engine(spec, "simfast")
    pool, pol, eng = spec.pool, spec.policy, spec.engine
    return FastConfig(
        pool_size=pool.pool_size,
        n_tasks=spec.n_tasks,
        batch_ratio=spec.batch_ratio,
        batch_size=spec.batch_size,
        n_records=spec.n_records,
        votes_needed=pol.redundancy.votes,
        n_classes=spec.n_classes,
        straggler=pol.straggler.enabled,
        max_dup=pol.straggler.max_dup,
        pm_l=pol.maintenance.pm_l,
        use_termest=pol.maintenance.use_termest,
        min_obs=pol.maintenance.min_obs,
        z=pol.maintenance.z,
        alpha=pol.maintenance.alpha,
        retainer=pool.retainer,
        recruit_mean_s=pool.recruit_mean_s,
        cold_recruit_mean_s=pool.cold_recruit_mean_s,
        session_mean_s=pool.session_mean_s,
        median_mu=pool.median_mu,
        sigma_ln=pool.sigma_ln,
        cv_lo=pool.cv_lo,
        cv_hi=pool.cv_hi,
        acc_a=pool.acc_a,
        acc_b=pool.acc_b,
        dt=eng.dt if eng.dt is not None else _FAST_DT,
        bundle_s=eng.bundle_s,
        mitig_bundle_s=eng.mitig_bundle_s,
        max_batch_time=eng.max_batch_time,
        latency_floor=pool.latency_floor,
        bank=pool.bank if pool.bank is not None else _FAST_BANK,
        trace=_trace_config(spec),
    )


def to_cs_config(spec: ScenarioSpec, *, seed: int = 0):
    """ScenarioSpec -> clamshell.CSConfig (scalar event-loop engine)."""
    from repro_torch.core.clamshell import CSConfig

    _check_batch_engine(spec, "events")
    pool, pol = spec.pool, spec.policy
    lr = pol.learner
    if spec.batch_size is not None:
        batch_ratio = pool.pool_size / spec.batch_size
    else:
        batch_ratio = spec.batch_ratio
    return CSConfig(
        pool_size=pool.pool_size,
        batch_ratio=batch_ratio,
        n_records=spec.n_records,
        votes_needed=pol.redundancy.votes,
        straggler=pol.straggler.enabled,
        routing="random",
        pm_l=pol.maintenance.pm_l,
        use_termest=pol.maintenance.use_termest,
        quality_threshold=None,
        learner=lr.kind,
        al_fraction=lr.al_fraction,
        al_batch=lr.al_batch,
        decision_latency_s=lr.decision_latency_s,
        async_retrain=lr.async_retrain,
        uncertainty_sample=lr.uncertainty_sample,
        retainer=pool.retainer,
        recruit_mean_s=pool.recruit_mean_s,
        cold_recruit_mean_s=pool.cold_recruit_mean_s,
        session_mean_s=pool.session_mean_s,
        seed=seed,
    )


def to_stream_config(spec: ScenarioSpec):
    """ScenarioSpec -> labelstream.StreamConfig (streaming engine)."""
    from repro_torch.labelstream.arrivals import ArrivalConfig
    from repro_torch.labelstream.policy import PolicyConfig
    from repro_torch.labelstream.router import (
        ShardingConfig, StreamConfig, StreamLearnerConfig,
    )
    from repro_torch.labelstream.routing import RoutingConfig

    if spec.arrivals.kind == "batch":
        _reject("stream", "arrivals.kind",
                "= 'batch'; the stream engine needs an arrival process "
                "(poisson | mmpp | diurnal)")
    if not spec.pool.retainer:
        _reject("stream", "pool.retainer",
                "= False; the streaming service runs on retainer pools")
    pool, pol, feat, eng = spec.pool, spec.policy, spec.features, spec.engine
    red, lr = pol.redundancy, pol.learner
    return StreamConfig(
        n_shards=pool.n_shards,
        pool_size=pool.pool_size,
        window=spec.window,
        backlog=spec.backlog,
        n_classes=spec.n_classes,
        dt=eng.dt if eng.dt is not None else _STREAM_DT,
        max_arrivals_per_tick=eng.max_arrivals_per_tick,
        arrivals=ArrivalConfig(
            kind=spec.arrivals.kind,
            rate=spec.arrivals.rate,
            rate_hi=spec.arrivals.rate_hi,
            dwell_mean_s=spec.arrivals.dwell_mean_s,
            period_s=spec.arrivals.period_s,
            amplitude=spec.arrivals.amplitude,
        ),
        policy=PolicyConfig(
            adaptive=red.adaptive,
            votes_cap=red.votes,
            conf_threshold=red.conf_threshold,
            min_votes=red.min_votes,
            max_outstanding=red.max_outstanding,
        ),
        batch_replay=pol.admission.batch_replay,
        p_hard=spec.difficulty.p_hard,
        hard_scale=spec.difficulty.hard_scale,
        straggler=pol.straggler.enabled,
        max_dup=pol.straggler.max_dup,
        pm_l=pol.maintenance.pm_l,
        use_termest=pol.maintenance.use_termest,
        min_obs=pol.maintenance.min_obs,
        z=pol.maintenance.z,
        alpha=pol.maintenance.alpha,
        recruit_mean_s=pool.recruit_mean_s,
        session_mean_s=pool.session_mean_s,
        median_mu=pool.median_mu,
        sigma_ln=pool.sigma_ln,
        cv_lo=pool.cv_lo,
        cv_hi=pool.cv_hi,
        acc_a=pool.acc_a,
        acc_b=pool.acc_b,
        latency_floor=pool.latency_floor,
        bank=pool.bank if pool.bank is not None else _STREAM_BANK,
        est_prior_acc=pool.est_prior_acc,
        est_prior_n=pool.est_prior_n,
        learner=StreamLearnerConfig(
            enabled=lr.enabled,
            n_features=feat.n_features,
            class_sep=feat.class_sep,
            hard_sep_scale=feat.hard_sep_scale,
            feature_kind=feat.kind,
            embed=to_embed_config(spec) if feat.kind == "lm" else None,
            prior_scale=lr.prior_scale,
            ramp_n=lr.ramp_n,
            known_threshold=lr.known_threshold,
            min_votes_known=lr.min_votes_known,
            fit_every=lr.fit_every,
            fit_steps=lr.fit_steps,
            lr=lr.lr,
            l2=lr.l2,
            buffer=lr.buffer,
            prioritize=lr.prioritize,
            train_crowd_only=lr.train_crowd_only,
        ),
        routing=RoutingConfig(
            enabled=pol.routing.kind == "scored",
            w_acc=pol.routing.w_acc,
            w_speed=pol.routing.w_speed,
            ewma_alpha=pol.routing.ewma_alpha,
            admission=pol.admission.kind,
        ),
        refresh_every=lr.refresh_every,
        refresh_iters=lr.refresh_iters,
        tis_bins=eng.tis_bins,
        tis_bin_s=eng.tis_bin_s,
        sharding=ShardingConfig(
            n_devices=spec.sharding.n_devices,
            steal=spec.sharding.steal,
            steal_max=spec.sharding.steal_max,
            steal_slack=spec.sharding.steal_slack,
        ),
        trace=_trace_config(spec),
    )


def to_embed_config(spec: ScenarioSpec):
    """ScenarioSpec -> ``repro_torch.embed.config.EmbedConfig``: an exact
    field copy of ``spec.embed``."""
    from repro_torch.embed.config import EmbedConfig

    em = spec.embed
    return EmbedConfig(
        model=em.model,
        reduced=em.reduced,
        pooling=em.pooling,
        seq_len=em.seq_len,
        bank_size=em.bank_size,
        projection_dim=em.projection_dim,
        batch_size=em.batch_size,
        seed=em.seed,
    )


def to_serve_config(spec: ScenarioSpec):
    """ScenarioSpec -> serve-mode StreamConfig for the live front end
    (:mod:`repro_torch.serving.server`): the exact :func:`to_stream_config`
    lowering with ``serve=True``, which swaps the sampled arrival process
    for injected per-shard counts and threads request uids through the
    backlog and window (``labelstream.router.serve_tick``). The HTTP surface
    (host, port, timeouts) stays host-side in ``spec.serve``."""
    return dataclasses.replace(to_stream_config(spec), serve=True)


def compile_for(spec: ScenarioSpec, engine: str, *, seed: int = 0):
    """Dispatch to the engine-specific compiler."""
    if engine == "events":
        return to_cs_config(spec, seed=seed)
    if engine == "simfast":
        return to_fast_config(spec)
    if engine == "stream":
        return to_stream_config(spec)
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
