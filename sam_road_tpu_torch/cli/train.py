"""Training CLI (counterpart of sam_road_tpu/cli/train.py, with the same
flags and behaviour, plus --device).

    python -m sam_road_tpu_torch.cli.train --config configs/toponet_vitb_512_cityscale.yaml
        [--resume CKPT] [--dev_run] [--fast_dev_run] [--data_root DIR]
        [--output_dir DIR] [--seed N] [--steps_per_epoch N] [--device cuda|cpu]

Weights start from models/sam_road.py::init_random(model, --seed), and then,
as in the JAX CLI: without --resume, the SAM checkpoint (--sam_ckpt or
SAM_CKPT_PATH, where the file exists) goes through models/convert.py::
load_and_convert (pos-embed resize, name-and-shape overlay), or with NO_SAM
the MAE trunk at MAE_CKPT_PATH through load_mae_encoder_params; where
neither file exists it prints "training from random init".
--device is PyTorch's device; the default, cuda, raises when torch sees no
GPU and never carries on on the CPU. One process: process_index 0 of 1.
Returns the Trainer.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default=None, help="checkpoint file (ckpt_epoch_N.pt)")
    parser.add_argument("--sam_ckpt", default=None, help="override SAM_CKPT_PATH (torch .pth)")
    parser.add_argument("--fast_dev_run", action="store_true")
    parser.add_argument("--dev_run", action="store_true")
    parser.add_argument("--data_root", default=".")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wandb", action="store_true", help="also log to wandb if installed")
    parser.add_argument("--steps_per_epoch", type=int, default=0,
                        help="override the virtual epoch length")
    parser.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU and torch sees none; "
                           "pass --device cpu to train on the CPU")

    from sam_road_tpu_torch.config import create_output_dir_and_save_config, load_config
    from sam_road_tpu_torch.data.dataset import BatchLoader, SatMapDataset
    from sam_road_tpu_torch.models.convert import load_and_convert, load_mae_encoder_params
    from sam_road_tpu_torch.models.sam_road import SAMRoad, init_random
    from sam_road_tpu_torch.training.harness import Trainer
    from sam_road_tpu_torch.utils.logging import MetricsLogger
    from sam_road_tpu_torch.utils.profiling import maybe_trace

    config = load_config(args.config)
    dev_run = args.dev_run or args.fast_dev_run
    output_dir = create_output_dir_and_save_config("./save/train", config,
                                                   specified_dir=args.output_dir)

    print("initializing params...", flush=True)
    model = init_random(SAMRoad.from_config(config), args.seed)
    sam_ckpt = args.sam_ckpt or config.SAM_CKPT_PATH
    if args.resume:
        pass  # the full train state is restored once the Trainer exists
    elif not config.NO_SAM and sam_ckpt and os.path.exists(sam_ckpt):
        model, matched, mismatched = load_and_convert(sam_ckpt, config, model)
        print("###### Matched params ######")
        print("\n".join(matched[:20] + [f"... {len(matched)} total"]))
        print("###### Mismatched params ######")
        print("\n".join(mismatched))
    elif config.NO_SAM and config.MAE_CKPT_PATH and os.path.exists(config.MAE_CKPT_PATH):
        model, matched, mismatched = load_mae_encoder_params(config.MAE_CKPT_PATH, config, model)
        print("###### Matched params (MAE init) ######")
        print("\n".join(matched[:20] + [f"... {len(matched)} total"]))
        print(f"({len(mismatched)} params stay at random init)")
    else:
        print("training from random init (no SAM checkpoint found)")

    train_ds = SatMapDataset(config, is_train=True, dev_run=dev_run, data_root=args.data_root)
    val_ds = SatMapDataset(config, is_train=False, dev_run=dev_run, data_root=args.data_root)

    batch_size = int(config.BATCH_SIZE)
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    if args.steps_per_epoch:
        steps_per_epoch = args.steps_per_epoch
    if args.fast_dev_run:
        steps_per_epoch = 2
    workers = max(1, int(config.DATA_WORKER_NUM or 1))
    train_loader = BatchLoader(train_ds, batch_size, seed=args.seed, num_batches=steps_per_epoch,
                               num_workers=workers)
    val_loader = BatchLoader(val_ds, batch_size, seed=args.seed)

    logger = MetricsLogger(output_dir, config=config, use_wandb=args.wandb, disabled=dev_run)
    trainer = Trainer(config, model, output_dir, steps_per_epoch, device=device, logger=logger)
    start_epoch = 0
    if args.resume:
        start_epoch = trainer.restore(args.resume)
        print(f"resumed full train state from {args.resume}; continuing at epoch {start_epoch}")
    epochs = 1 if args.fast_dev_run else int(config.TRAIN_EPOCHS)
    for epoch in range(start_epoch, epochs):
        with maybe_trace(config.TRACE_DIR or None):
            trainer.train_epoch(train_loader, epoch)
        metrics = trainer.validate(val_loader, epoch=epoch,
                                   viz_count=int(config.VAL_VIZ_COUNT or 4))
        printable = {k: v for k, v in metrics.items() if not k.startswith("_")}
        print(f"epoch {epoch} val: {printable}", flush=True)
        ckpt = trainer.save_checkpoint(epoch)
        logger.log({"epoch": epoch, **printable})
        print(f"saved {ckpt}", flush=True)
    logger.finish()
    return trainer


if __name__ == "__main__":
    main()
