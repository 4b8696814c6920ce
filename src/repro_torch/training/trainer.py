"""The fault-tolerant training loop on one device or a mesh (port of
``src/repro/training/trainer.py``).

Wires together the step function (:mod:`repro_torch.models.stepfn`), AdamW
with the cosine schedule, atomic checkpoints (optionally written on a
background thread), the straggler-mitigated prefetch loader and optional
gradient compression (on one device or a mesh). Parameters are drawn from
a CPU ``torch.Generator`` seeded with ``TrainConfig.seed``, so a seed
gives the same model on every device. On a mesh (``mesh=``, an
:class:`~repro_torch.launch.mesh.LMMesh`) the parameters and the
optimizer state are laid out by the parameters' specs, the step's MoE
groups are ``mesh.size`` (the reference's ``mesh.devices.size``: every
slot, not the data groups), checkpoints hold the gathered state and a
restore lays it out again. Left out: the reference's host monitoring and
elastic restart. One repair: the loader starts at the restored step, so a
run that crashes, restores and continues sees the same batches as a run
straight through (the reference's loader restarts at batch 0).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.data.corpus import CorpusConfig, PrefetchLoader
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import compress_tree
from repro_torch.distributed.sharding import named, param_pspecs, put
from repro_torch.models.model import model_template
from repro_torch.models.params import PSpec, init_params, tree_map
from repro_torch.models.stepfn import make_train_step
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamW, cosine_schedule


@dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 20
    microbatches: int = 1
    remat: bool = True
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_background: bool = True
    compression: bool = False
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg, corpus: CorpusConfig, tc: TrainConfig, *,
                 mesh=None, constrain=None, log=print, device="cuda"):
        self.cfg = cfg
        self.corpus = corpus
        self.tc = tc
        self.mesh = mesh
        self.log = log
        self.device = mesh.lead if mesh is not None else \
            resolve_device(device)
        self.opt = AdamW(lr=tc.lr, schedule=cosine_schedule(
            tc.lr, tc.warmup, tc.steps))
        self.step_fn = make_train_step(
            cfg, self.opt, microbatches=tc.microbatches, remat=tc.remat,
            constrain=constrain, mesh=mesh,
            moe_groups=mesh.size if mesh is not None else 1,
            grad_transform=compress_tree if tc.compression else None)
        self.metrics_log: list = []

    # ------------------------------------------------------------------
    def shardings(self):
        """The state's layout on the mesh (None on one device): parameters
        and moments by the parameters' specs, the counters whole on the
        lead device."""
        if self.mesh is None:
            return None
        ps = named(param_pspecs(model_template(self.cfg), self.mesh),
                   self.mesh)
        return {"params": ps,
                "opt_state": {"mu": ps, "nu": ps, "count": None},
                "step": None}

    def init_state(self):
        params = init_params(model_template(self.cfg),
                             torch.Generator().manual_seed(self.tc.seed),
                             device="cpu" if self.mesh is not None
                             else self.device)
        if self.mesh is not None:
            params = put(params, param_pspecs(model_template(self.cfg),
                                              self.mesh), self.mesh)
        return {"params": params, "opt_state": self.opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def state_template(self):
        """The state's structure with ``meta`` tensors as leaves (nothing
        drawn or allocated)."""
        meta = tree_map(lambda p: torch.empty(p.shape, device="meta"),
                        model_template(self.cfg),
                        is_leaf=lambda x: isinstance(x, PSpec))
        scalar = torch.empty((), dtype=torch.int32, device="meta")
        return {"params": meta,
                "opt_state": {"mu": meta, "nu": meta, "count": scalar},
                "step": scalar}

    def restore_or_init(self):
        if self.tc.ckpt_dir:
            state, step = ckpt.restore(self.tc.ckpt_dir,
                                       self.state_template(),
                                       shardings=self.shardings(),
                                       device=self.device)
            if state is not None:
                self.log(f"[trainer] restored checkpoint at step {step}")
                return state
        return self.init_state()

    # ------------------------------------------------------------------
    def run(self, *, loader=None, max_steps=None, fail_at_step=None):
        """Train to ``tc.steps`` (or ``max_steps``); ``fail_at_step``
        injects a crash (tests). Without a ``loader`` it makes its own,
        starting at the restored step."""
        tc = self.tc
        state = self.restore_or_init()
        step = int(state["step"])
        own_loader = loader is None
        loader = loader or PrefetchLoader(self.corpus, start_step=step)
        pending_save = None
        t0 = time.time()
        try:
            while step < (max_steps or tc.steps):
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in next(loader).items()}
                state, metrics = self.step_fn(state, batch)
                step += 1
                if fail_at_step is not None and step >= fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                if step % tc.log_every == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    self.metrics_log.append((step, m))
                    self.log(f"[trainer] step {step:5d} loss {m['loss']:.4f} "
                             f"gnorm {m['grad_norm']:.3f} "
                             f"({(time.time() - t0):.1f}s)")
                if tc.ckpt_dir and step % tc.ckpt_every == 0:
                    if pending_save is not None:
                        pending_save.join()
                    pending_save = ckpt.save(tc.ckpt_dir, step, state,
                                             background=tc.ckpt_background)
        finally:
            if pending_save is not None:
                pending_save.join()
            if own_loader:
                loader.stop()
        return state
