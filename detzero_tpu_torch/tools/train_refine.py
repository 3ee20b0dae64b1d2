"""Refining training CLI (port of tools/train_refine.py; reference
refining/tools/train.py surface): one run trains one of GRM, PRM and CRM
for one class, as the model config names them.

    python -m detzero_tpu_torch.tools.train_refine \
        --cfg_file configs/ref_model_cfgs/vehicle_grm.yaml
    python -m detzero_tpu_torch.tools.train_refine \
        --cfg_file configs/ref_model_cfgs/synthetic_grm.yaml \
        --device cpu --max_steps 2 --set DATA_PATH <daemon output>

Builds the refine dataset over the daemon's records under
DATA_PATH/<CLASS_NAME>/, the model from REFINE_MODULES (float32, weights
drawn from --seed), the optimizer and the trainer, resumes from the newest
checkpoint of <output_dir>/<cfg stem>/<extra_tag>/ckpt and trains to the
step count.  `main(argv)` runs in-process and returns the Trainer (None
when there are no records, as the reference logs and returns; it raises
`TooFewTracks` when the tracks cannot fill one batch).  Under
torchrun or SLURM it trains data parallel as train_det does: the global
batch is BATCH_SIZE_PER_DEVICE x the ranks, one card a rank.
"""

from __future__ import annotations

import numpy as np
import torch

MODEL_KIND = {"GeometryTransformer": "grm", "PositionTransformer": "prm",
              "ConfidencePointNet": "crm"}


class TooFewTracks(ValueError):
    """The class's training tracks cannot fill one global batch: the
    loader drops the last partial batch, so an epoch would be empty."""


def build_refine_dataset(cfg, training, logger=None, records=None, rng=None):
    from detzero_tpu_torch.core.registry import DATASETS
    import detzero_tpu_torch.data.refine_dataset  # noqa: F401 (registers)

    return DATASETS.get(cfg["DATASET"])(
        cfg, cfg.get("CLASS_NAME", "Vehicle"), training=training,
        logger=logger, records=records, rng=rng)


def size_anchors(cfg):
    """The class's GRM size anchors (MODEL.SIZE_ANCHORS, else the
    defaults)."""
    from detzero_tpu_torch.models.refining.target_assign import (
        DEFAULT_SIZE_ANCHORS,
    )

    cls = cfg.get("CLASS_NAME", "Vehicle")
    return np.asarray(cfg["MODEL"].get("SIZE_ANCHORS",
                                       DEFAULT_SIZE_ANCHORS[cls]), np.float32)


def build_refine_model(cfg, device, seed: int = 0):
    """The config's refining model on `device` (the sizes read as
    tools/train_refine.py reads them; point features from
    POINT_FEATURES), float32, its weights drawn on the CPU from `seed`."""
    from detzero_tpu_torch.core.registry import REFINE_MODULES
    import detzero_tpu_torch.models.refining  # noqa: F401 (registers)

    m = cfg["MODEL"]
    name = m["NAME"]
    kw = {"d_model": int(m.get("D_MODEL", 256)), "device": "cpu"}
    if name != "ConfidencePointNet":
        kw["n_heads"] = int(m.get("N_HEADS", 4))
        kw["num_decoder_layers"] = int(m.get("NUM_DECODER_LAYERS", 1))
    if name == "GeometryTransformer":
        kw["num_anchors"] = int(m.get("NUM_ANCHORS", 3))
        kw["num_features"] = int(cfg.get("POINT_FEATURES", 11))
        kw["anchors"] = size_anchors(cfg)
    if name == "PositionTransformer":
        kw["mem_points"] = int(cfg.get("MEMORY_POINTS", 48))
        kw["num_features"] = int(cfg.get("POINT_FEATURES", 32))
    if name == "ConfidencePointNet":
        kw["num_features"] = int(cfg.get("POINT_FEATURES", 32))
        kw["iou_band"] = m.get("IOU_BANDS", {}).get(
            cfg.get("CLASS_NAME", "Vehicle"), [0.35, 0.7])
    model = REFINE_MODULES.get(name)(**kw)
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def main(argv=None):
    from detzero_tpu_torch.core.logger import set_random_seed
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.data.waymo_dataset import build_dataloader
    from detzero_tpu_torch.parallel.trainer import Trainer
    from detzero_tpu_torch.tools.common import (
        base_parser, init_data_parallel, load_config, setup_experiment,
    )
    from detzero_tpu_torch.core.mesh import rank_rng

    parser = base_parser("detzero_tpu_torch refining training")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="hard step cap (smoke runs)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, the samples' draws and "
                             "the loader's order")
    parser.add_argument("--log_every", type=int, default=10,
                        help="steps between metrics.jsonl lines")
    args = parser.parse_args(argv)
    device, rank, world = init_data_parallel(args.device)
    cfg = load_config(args)
    exp_dir, logger = setup_experiment(args, cfg, "train")

    set_random_seed(args.seed)
    # the samples' draws: RandomState(seed) on rank 0, (seed, rank) else
    dataset = build_refine_dataset(cfg, training=True, logger=logger,
                                   rng=rank_rng(args.seed, rank))
    if len(dataset) == 0:
        logger.error("no refining records found — run the daemon first "
                     "(detzero_tpu_torch.tools.prepare_object_data)")
        return None
    opt_cfg = cfg["OPTIMIZATION"]
    batch_size = int(opt_cfg.get("BATCH_SIZE_PER_DEVICE", 8))
    global_batch = batch_size * world
    if len(dataset) < global_batch:
        raise TooFewTracks(f"{len(dataset)} training tracks cannot fill "
                           f"one batch of {global_batch}")
    total_steps = args.max_steps or max(len(dataset) // global_batch, 1) \
        * int(opt_cfg.get("NUM_EPOCHS", 60))
    logger.info(f"device={device} ranks={world} batch={global_batch} "
                f"steps={total_steps}")
    model = build_refine_model(cfg, device, seed=args.seed)
    loader = build_dataloader(dataset, batch_size, shuffle=True,
                              num_workers=args.workers, seed=args.seed,
                              rank=rank, world=world)
    trainer = Trainer(model, build_optimizer(opt_cfg, total_steps, model),
                      ckpt_dir=exp_dir / "ckpt", logger=logger,
                      log_every=args.log_every, seed=args.seed)
    trainer.resume()

    def batches():
        ep = 0
        while True:
            yield from loader(ep)
            ep += 1

    trainer.fit(batches(), total_steps,
                save_every=int(opt_cfg.get("SAVE_EVERY", 500)),
                profile_dir=args.profile_dir)
    logger.info("refining training done")
    return trainer


if __name__ == "__main__":
    main()
