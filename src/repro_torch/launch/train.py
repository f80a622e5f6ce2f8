"""Training launcher (the port of the reference's ``launch/train.py``).

Runs a REDUCED config of ``--arch`` end to end on one device: the data
pipeline, checkpointing, restart.  ``--full-config`` takes the full
width and depth instead.  ``--device`` defaults to the card (and raises
without one); on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internlm2-1.8b --steps 20 --device cpu

``--path regc`` (gradient sync across processes) and the sync options
other than their defaults (``--sync-granularity object``,
``--sync-compression int8_ring``) wait for ROADMAP item 13d: they raise.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="repro_torch trainer")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--path", choices=["gspmd", "regc"], default="gspmd")
    ap.add_argument("--sync-granularity", choices=["object", "bucket"],
                    default="bucket")
    ap.add_argument("--sync-compression", choices=["none", "int8_ring"],
                    default="none")
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", choices=["synthetic", "memmap"],
                    default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the FULL assigned config")
    ap.add_argument("--reduced-periods", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import DataConfig
    from repro_torch.regc_sync.policies import RegCSyncPolicy
    from repro_torch.train.train_step import REGC_PENDING, TrainHParams
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.path == "regc":
        raise NotImplementedError(REGC_PENDING)
    cfg = (get_config(args.arch) if args.full_config
           else get_reduced(args.arch, n_periods=args.reduced_periods))
    sync = RegCSyncPolicy(
        ordinary_sync="lazy", granularity=args.sync_granularity,
        compression=None if args.sync_compression == "none" else
        args.sync_compression)
    hp = TrainHParams(lr=args.lr, warmup=max(1, args.steps // 20),
                      total_steps=args.steps, n_micro=args.n_micro,
                      remat=args.remat, ce_chunk=min(1024, args.seq_len),
                      sync=sync)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, path=args.path)
    data = DataConfig(kind=args.data, vocab_size=cfg.vocab_size,
                      seq_len=args.seq_len, global_batch=args.global_batch,
                      path=args.data_path)
    trainer = Trainer(cfg, hp, tc, data, device=args.device)
    out = trainer.run()
    print(f"done: step={out['step']} final_loss={out['history'][-1]['loss']:.4f} "
          f"restarts={out['restarts']}")
    return out


if __name__ == "__main__":
    main()
