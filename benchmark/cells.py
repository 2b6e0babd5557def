"""The two runners of a cell: region inference through
TiledInferenceEngine.infer_tiles, and training through Trainer.train_epoch.
Each builds the program from the configuration file and the state dict
that benchmark/reference/model.py makes from the seed, warms every shape
of the cell's traffic (set-up), measures for the window, optionally traces
a short segment after it, and returns what the metrics and the check read.

These are the only modules of the benchmark that import the program
(sam_road_tpu_torch); the reference never does.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchmark import trace as trace_mod, traffic
from benchmark.reference import model as ref_model


def arch_of(config_file: dict) -> dict:
    """The reference's view of a configuration: its published sizes and
    the patch size it runs at."""
    return {**config_file["published"], "PATCH_SIZE": int(config_file["config"]["PATCH_SIZE"])}


def build_program(config: dict, sd: dict, device):
    """(config, SAMRoad) of the program: the module built without
    initialising its parameters, then given the state dict sd."""
    from sam_road_tpu_torch.config import load_config
    from sam_road_tpu_torch.models.sam_road import SAMRoad

    cfg = load_config(overrides=config)
    with torch.device("meta"):
        net = SAMRoad.from_config(cfg)
    net = net.to_empty(device=device)
    net.load_state_dict(sd)
    return cfg, net


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def reset_peak(device) -> None:
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def annotated(obj, attr: str, span: str, record=None):
    """Within the block, obj.attr runs inside record_function(span);
    `record(*args)` is called first where given."""
    from torch.profiler import record_function

    original = getattr(obj, attr)

    def wrapper(*args, **kwargs):
        if record is not None:
            record(*args)
        with record_function(span):
            return original(*args, **kwargs)

    setattr(obj, attr, wrapper)
    try:
        yield
    finally:
        setattr(obj, attr, original)


# ---------------------------------------------------------------- regions


def region(config_file: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
           t_start: float) -> dict:
    from sam_road_tpu_torch.inference import engine as engine_mod

    arch = arch_of(config_file)
    weights_seed = traffic.weights_seed(mix, seed)
    sd = ref_model.make_weights(arch, weights_seed, device)
    cfg, net = build_program(config_file["config"], sd, device)
    del sd
    engine = engine_mod.TiledInferenceEngine(cfg, net, device)
    regions = traffic.regions(mix, seed)

    # calibration: masks do not depend on the thresholds; at 1.0 no vertex
    cfg.ITSC_THRESHOLD = cfg.ROAD_THRESHOLD = 1.0
    _, _, kp, road = engine.infer_one_img(regions[0])
    thresholds = dict(ITSC_THRESHOLD=float(np.quantile(kp / 255.0, mix["itsc_quantile"])),
                      ROAD_THRESHOLD=float(np.quantile(road / 255.0, mix["road_quantile"])))
    cfg.update(thresholds)
    for _ in engine.infer_tiles(regions):  # every shape of the window
        pass
    sync(device)
    setup_peak = peak_bytes(device)
    reset_peak(device)
    setup_s = time.perf_counter() - t_start

    outputs, timings = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def feed():
        i = 0
        while time.perf_counter() < deadline:
            yield regions[i % len(regions)]
            i += 1

    # the host aggregation's input, (source, target, int16 score) triples
    # a patch, kept by reference for the check: TopoNet's scores as the
    # timed path produced them
    aggregate, captured = engine._aggregate_edges, []
    engine._aggregate_edges = lambda scored, n: captured.append(scored) or aggregate(scored, n)
    scores = []
    for out in engine.infer_tiles(feed()):
        outputs.append(out)
        timings.append(dict(engine.last_timings))
        scores.append(captured.pop() if captured else None)
    engine._aggregate_edges = aggregate
    sync(device)
    window_s = time.perf_counter() - t0
    window_peak = peak_bytes(device)

    traced = None
    if trace:
        batches = []
        spans = ("bench.encoder", "bench.extract", "bench.p2_build", "bench.aggregate")
        with contextlib.ExitStack() as stack:
            if engine.encoder is not None:  # the fused encoder, which the engine calls
                stack.enter_context(annotated(engine, "encoder", spans[0],
                                              lambda module, x: batches.append(int(x.shape[0]))))
            else:  # the eager encoder, the model's own
                stack.enter_context(annotated(net.image_encoder, "forward", spans[0],
                                              lambda x: batches.append(int(x.shape[0]))))
            stack.enter_context(annotated(engine_mod, "extract_graph_points", spans[1]))
            stack.enter_context(annotated(engine, "_build_args", spans[2]))
            stack.enter_context(annotated(engine, "_aggregate_edges", spans[3]))
            with trace_mod.traced(device) as seg:
                for _ in engine.infer_tiles(regions):
                    pass
        traced = trace_mod.reduce(seg["prof"], seg["window_s"], spans,
                                  kernels=("relpos_attention_kernel", "window_attention_kernel"))
        traced["encoder_batches"] = batches
        traced["units"] = len(regions)
        del seg
    del engine, net
    free(device)
    return dict(kind="region", arch=arch, cfg=dict(config_file["config"]), mix=mix,
                weights_seed=weights_seed, regions=regions, calibration=(kp, road),
                thresholds=thresholds, outputs=outputs, scores=scores,
                timings=timings, window_s=window_s, units=len(outputs), setup_s=setup_s,
                peak_window=window_peak, peak=max(setup_peak, window_peak), trace=traced)


def distinct_outputs(run: dict) -> list:
    """[(region index, output, its phase-2 scores)] for each distinct
    output of the window: equal outputs of one region are compared once."""
    seen, out = set(), []
    n = len(run["regions"])
    for j, (o, scored) in enumerate(zip(run["outputs"], run["scores"])):
        nodes, edges, kp, road = o
        key = (j % n, hash(nodes.tobytes()), hash(edges.tobytes()), hash(kp.tobytes()),
               hash(road.tobytes()))
        if key not in seen:
            seen.add(key)
            out.append((j % n, o, scored))
    return out


# ---------------------------------------------------------------- training


class Cycle:
    """The window's loader: the batches in order, again and again, until
    `deadline` (perf_counter seconds) or `limit` batches."""

    def __init__(self, batches, deadline=float("inf"), limit=None):
        self.batches, self.deadline, self.limit = batches, deadline, limit
        self.count = 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        while time.perf_counter() < self.deadline and (self.limit is None
                                                       or self.count < self.limit):
            yield self.batches[self.count % len(self.batches)]
            self.count += 1


def _host_copy(named) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in named}


def train(config_file: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> dict:
    from sam_road_tpu_torch.models import vit
    from sam_road_tpu_torch.training.harness import Trainer

    arch = arch_of(config_file)
    weights_seed = traffic.weights_seed(mix, seed)
    sd = ref_model.make_weights(arch, weights_seed, device)
    cfg, net = build_program(config_file["config"], sd, device)
    del sd
    batches = traffic.train_batches(mix, config_file["config"], seed)
    trainer = Trainer(cfg, net, output_dir=".", steps_per_epoch=len(batches), device=device,
                      log_every=10 ** 9)
    n_check = int(mix["checked_steps"])

    # the checked steps, through the window's own call and feed
    trainer.train_epoch(batches[:1], 0)
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    state = trainer.optimizer.state
    first_grad = {k: (state[p]["exp_avg"] / (1 - beta1)).cpu() if "exp_avg" in state[p]
                  else torch.zeros(p.shape) for k, p in net.named_parameters()}
    trainer.train_epoch(batches[1:n_check], 0)
    program = dict(losses=[h["loss"] for h in trainer.history[:n_check]],
                   grad_norm=trainer.history[0]["grad_norm"],
                   skipped=sum(h["skipped"] for h in trainer.history[:n_check]),
                   first_grad=first_grad, params=_host_copy(net.named_parameters()))
    trainer.train_epoch(batches[n_check:], 0)  # the remaining batches' shapes
    sync(device)
    setup_peak = peak_bytes(device)
    reset_peak(device)
    setup_s = time.perf_counter() - t_start

    loader = Cycle(batches, deadline=time.perf_counter() + seconds)
    t0 = time.perf_counter()
    trainer.train_epoch(loader, 1)
    sync(device)
    window_s = time.perf_counter() - t0
    window_peak = peak_bytes(device)

    traced = None
    if trace:
        spans = ("bench.attention", "_FusedAttentionBackward", "bench.step")
        steps = int(mix["traced_steps"])
        with annotated(vit, "fused_attention", spans[0]), \
                annotated(trainer, "_train_step", spans[2]):
            with trace_mod.traced(device) as seg:
                trainer.train_epoch(Cycle(batches, limit=steps), 2)
        traced = trace_mod.reduce(seg["prof"], seg["window_s"], spans,
                                  kernels=("relpos_attention_kernel", "folded_attention"))
        traced["units"] = steps
        del seg
    del trainer, net
    free(device)
    return dict(kind="train", arch=arch, cfg=dict(config_file["config"]), mix=mix,
                weights_seed=weights_seed, batches=batches, program=program, window_s=window_s, units=loader.count,
                setup_s=setup_s, peak_window=window_peak, peak=max(setup_peak, window_peak),
                trace=traced)
