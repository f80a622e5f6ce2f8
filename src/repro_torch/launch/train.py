"""Training launcher (the port of the reference's ``launch/train.py``).

Runs a REDUCED config of ``--arch`` end to end: the data pipeline,
checkpointing, restart.  ``--full-config`` takes the full width and
depth instead.  ``--device`` defaults to the card (and raises without
one); on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internlm2-1.8b --steps 20 --device cpu

``--path regc`` trains data-parallel over the ranks of a
``torch.distributed`` world with RegC's gradient sync
(``--sync-granularity``, ``--sync-compression``), over gloo
(``--backend``, its one choice: ranks that share a card cannot run
NCCL).  Under
``python -m torch.distributed.run`` every rank joins that world (and
``--device cuda`` puts rank ``LOCAL_RANK`` on card ``LOCAL_RANK``
modulo the cards there are); without it the world is this one process:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --path regc --device cpu --steps 20

Rank 0 writes the checkpoints and prints ``done: ...``, then every
rank's final loss, which must agree, and the model kernels' launches
summed over the ranks.  On the default path the sync options
other than their defaults raise (one process syncs nothing).
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
    ap.add_argument("--backend", choices=["gloo"], default="gloo",
                    help="torch.distributed backend of --path regc")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import DataConfig
    from repro_torch.regc_sync.policies import RegCSyncPolicy
    from repro_torch.train.train_step import TrainHParams
    from repro_torch.train.trainer import Trainer, TrainerConfig

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
    if args.path != "regc":
        out = Trainer(cfg, hp, tc, data, device=args.device).run()
        print(f"done: step={out['step']} "
              f"final_loss={out['history'][-1]['loss']:.4f} "
              f"restarts={out['restarts']}")
        return out
    return _run_regc(args, cfg, hp, tc, data)


def _run_regc(args, cfg, hp, tc, data):
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention, ssd_chunk
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import init_world, rank_device
    from repro_torch.train.trainer import Trainer

    device = rank_device(args.device)
    owned = init_world(args.backend)
    try:
        world = dist.get_world_size()
        mesh = make_host_mesh((world,), ("data",))
        out = Trainer(cfg, hp, tc, data, mesh=mesh, device=device).run()
        # every rank's final loss, gathered on the host (gloo)
        mine = torch.tensor([out["history"][-1]["loss"]],
                            dtype=torch.float64)
        losses = [torch.zeros_like(mine) for _ in range(world)]
        dist.all_gather(losses, mine)
        losses = [float(t) for t in losses]
        launched = {**flash_attention.LAUNCHES, **ssd_chunk.LAUNCHES}
        counts = torch.tensor([launched[k] for k in sorted(launched)],
                              dtype=torch.int64)
        dist.all_reduce(counts)
        launched = dict(zip(sorted(launched), counts.tolist()))
        if dist.get_rank() == 0:
            print(f"done: step={out['step']} "
                  f"final_loss={out['history'][-1]['loss']:.4f} "
                  f"restarts={out['restarts']}")
            print(f"ranks: world={world} backend={args.backend} "
                  f"final_losses={losses} launches={launched}", flush=True)
        if len(set(losses)) != 1:
            raise RuntimeError(f"the ranks' final losses differ: {losses}")
        out.update(final_losses=losses, launches=launched)
        return out
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
