"""One rank of the port's two-process data-parallel checks
(tests/test_torch_dp_training.py): joins a gloo process group on the CPU,
takes its rows of each global batch in setup.pt (parallel.shard_batch) and
runs every case through training/harness.py's Trainer under
DistributedDataParallel (validation, then the training steps), then saves
what it saw to rank<r>.pt.

    python tests/torch_dp_worker.py RANK WORLD PORT WORKDIR
"""

import sys

import torch
import torch.distributed as dist


def main(rank: int, world: int, port: int, workdir: str) -> None:
    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad
    from sam_road_tpu_torch.parallel import shard_batch
    from sam_road_tpu_torch.training.harness import Trainer

    torch.manual_seed(0)
    setup = torch.load(f"{workdir}/setup.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    out = {}
    try:
        for name, case in setup["cases"].items():
            cfg = load_config(overrides=case["config"])
            model = SAMRoad.from_config(cfg)
            model.load_state_dict(case["state"])
            trainer = Trainer(cfg, model, workdir, steps_per_epoch=10, device="cpu",
                              log_every=1, deterministic=True)
            metrics = trainer.validate([shard_batch(b, rank, world) for b in case["eval"]])
            logs = trainer.train_epoch([shard_batch(b, rank, world) for b in case["train"]],
                                       epoch=0)
            out[name] = dict(logs=logs, metrics=metrics,
                             params={n: p.detach().clone() for n, p in model.named_parameters()},
                             grads={n: p.grad.clone() for n, p in model.named_parameters()})
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{workdir}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
