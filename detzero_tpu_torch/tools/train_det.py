"""Detection training CLI (port of tools/train_det.py; reference
detection/tools/train.py surface):

    python -m detzero_tpu_torch.tools.train_det \
        --cfg_file configs/det_model_cfgs/centerpoint_5sweeps.yaml
    python -m detzero_tpu_torch.tools.train_det \
        --cfg_file configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml \
        --device cpu --max_steps 2       # no card, no Waymo data

Builds the dataset, the loader, the model, the optimizer and the trainer,
resumes from the newest checkpoint of the experiment directory
(<output_dir>/<cfg stem>/<extra_tag>/ckpt) and trains to the step count.
`main(argv)` runs in-process and returns the Trainer.

Data parallel, one process a card, as the reference trains over all its
devices: under torchrun or SLURM the global batch is BATCH_SIZE_PER_DEVICE
x the ranks, each rank runs on its own card (a bare `--device cuda` is
cuda:LOCAL_RANK) and the steps of an epoch come from the global batch:

    torchrun --nproc_per_node 2 -m detzero_tpu_torch.tools.train_det \
        --cfg_file configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml \
        --device cpu --max_steps 2
"""

from __future__ import annotations


def main(argv=None):
    from detzero_tpu_torch.tools.common import (
        base_parser, build_detection_dataset, build_detector,
        init_data_parallel, load_config, setup_experiment,
    )

    parser = base_parser("detzero_tpu_torch detection training")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="hard step cap (smoke runs)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, the augmentation and "
                             "the second stage's RoI draws (with the step)")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="optimizer steps a call (their means are "
                             "logged)")
    parser.add_argument("--log_every", type=int, default=50,
                        help="steps between metrics.jsonl lines")
    args = parser.parse_args(argv)
    device, rank, world = init_data_parallel(args.device)
    cfg = load_config(args)
    exp_dir, logger = setup_experiment(args, cfg, "train")

    from detzero_tpu_torch.core.logger import set_random_seed
    from detzero_tpu_torch.core.mesh import rank_rng
    from detzero_tpu_torch.core.optim import build_optimizer
    from detzero_tpu_torch.data.waymo_dataset import build_dataloader
    from detzero_tpu_torch.parallel.trainer import Trainer

    set_random_seed(args.seed)
    # the samples' augmentation draws: RandomState(seed) on rank 0, as one
    # process draws, and a stream of (seed, rank) on the others
    dataset = build_detection_dataset(cfg, training=True, logger=logger,
                                      rng=rank_rng(args.seed, rank))
    opt_cfg = cfg["OPTIMIZATION"]
    batch_size = int(opt_cfg.get("BATCH_SIZE_PER_DEVICE", 1))
    epochs = int(opt_cfg.get("NUM_EPOCHS", 12))
    steps_per_epoch = max(len(dataset) // (batch_size * world), 1)
    total_steps = args.max_steps or steps_per_epoch * epochs
    logger.info(f"device={device} ranks={world} batch={batch_size * world} "
                f"steps={total_steps}")

    model = build_detector(cfg, device, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params/1e6:.2f} M")
    loader = build_dataloader(dataset, batch_size, shuffle=True,
                              num_workers=args.workers, rank=rank,
                              world=world)
    trainer = Trainer(model, build_optimizer(opt_cfg, total_steps, model),
                      ckpt_dir=exp_dir / "ckpt", logger=logger,
                      log_every=args.log_every, tb_dir=exp_dir / "tb",
                      steps_per_call=args.steps_per_call, seed=args.seed)
    trainer.resume()

    def batches():
        ep = 0
        while True:
            yield from loader(ep)
            ep += 1

    trainer.fit(batches(), total_steps,
                save_every=int(opt_cfg.get("SAVE_EVERY", steps_per_epoch)),
                profile_dir=args.profile_dir)
    logger.info("training done")
    return trainer


if __name__ == "__main__":
    main()
