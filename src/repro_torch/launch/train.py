"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100 \
        --arch recurrentgemma-2b --seq 512 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --steps 5 --device cpu

Runs :class:`repro_torch.training.trainer.Trainer` on one device (the card
by default; ``--device cpu`` runs the kernels' plain versions) over the
synthetic corpus. ``--reduced`` trains the smoke-scale config of the same
family. Every registered architecture builds; the synthetic corpus feeds
token batches only, so the cross-attending ones (whisper-base,
llama-3.2-vision-11b), whose loss needs a ``cross_src``, do not train
here.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, reduced
from repro_torch.data.corpus import CorpusConfig
from repro_torch.training.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    corpus = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=0)
    tc = TrainConfig(steps=args.steps, lr=args.lr,
                     microbatches=args.microbatches,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     compression=args.compression)
    trainer = Trainer(cfg, corpus, tc, device=args.device)
    return trainer.run()


if __name__ == "__main__":
    main()
