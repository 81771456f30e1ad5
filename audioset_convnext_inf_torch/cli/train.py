"""Training CLI (reference pytorch/main.py train), on one card or
data-parallel over several.

    python -m audioset_convnext_inf_torch.cli.train \\
        --train-indexes train_idx.h5 --eval-indexes eval_idx.h5 \\
        [--bal-indexes bal_idx.h5] [--model convnext_tiny] \\
        [--sampler balanced|uniform|alternate] [--batch-size 128] \\
        [--mixup-alpha 1.0] [--early-stop 75000] [--workspace ./workspace] \\
        [--resume-iteration N] [--device cpu|cuda]

The JAX package's flags, recipe and workspace layout:
``checkpoints/<model>/<N>_iterations`` (parameters, optimizer, sampler
state and iteration, every ``--checkpoint-interval`` and at the end),
``statistics/<model>/statistics.pkl`` (mAP, AUC, d-prime per evaluation),
``logs/<model>`` and ``metrics/<model>``. ``--resume-iteration N`` restores
parameters, optimizer, sampler and statistics from a checkpoint of either
package (a JAX checkpoint's optax state is converted), so the resumed run
sees the batches the uninterrupted one would have. Runs on the card unless
``--device cpu`` is given. The index and waveform HDF5 files need h5py,
imported where they are opened.

Data parallelism: one process per card, launched by torchrun or SLURM
(``parallel.initialize_distributed`` reads either environment; without
one the run is one process on one card):

    torchrun --nproc-per-node 4 -m audioset_convnext_inf_torch.cli.train ...
    srun --ntasks-per-node 4 --gpus-per-node 4 \\
        python -m audioset_convnext_inf_torch.cli.train ...

``--batch-size`` is the global batch (a multiple of the number of
processes; with mixup, the 2 x batch clips split into pairs). Every rank
builds the same sampler from the same seed and loads only its own rows of
each batch; the sampler state stays the global one. Only the primary (rank
0) writes the metric log, the statistics and the checkpoints, and only it
evaluates, on its own card, while the others wait in their next
all-reduce. Every rank resumes from the same checkpoint. The JAX package's
persistent compilation cache has no counterpart here.

``main`` parses the flags and opens the index files and the datasets;
:func:`train` runs everything from the sampler on, over indexes and
datasets already in memory.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Dict, Optional


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--train-indexes", required=True)
    parser.add_argument("--eval-indexes", default=None)
    parser.add_argument("--bal-indexes", default=None)
    parser.add_argument("--model", default="convnext_tiny")
    parser.add_argument("--after-stem-dim", type=int, nargs="+", default=[252, 56])
    # frontend geometry (main.py:939-944); the defaults are the published
    # ConvNeXt recipe's (224 mel bins)
    parser.add_argument("--sample-rate", type=int, default=32000)
    parser.add_argument("--window-size", type=int, default=1024)
    parser.add_argument("--hop-size", type=int, default=320)
    parser.add_argument("--mel-bins", type=int, default=224)
    parser.add_argument("--fmin", type=float, default=50.0)
    parser.add_argument("--fmax", type=float, default=14000.0)
    parser.add_argument("--sampler", default="balanced", choices=["uniform", "balanced", "alternate"])
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--max-lr", type=float, default=4e-4)
    parser.add_argument("--total-steps", type=int, default=75000)
    parser.add_argument("--optimizer", default="adamw", choices=["adam", "adamw"])
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--use-wd-scheduler", action="store_true",
                        help="schedule weight decay over training (main.py --use_wd_scheduler)")
    parser.add_argument("--mixup-alpha", type=float, default=0.0)
    parser.add_argument("--drop-path-rate", type=float, default=0.1)
    parser.add_argument("--accumulation-steps", type=int, default=1)
    parser.add_argument("--use-speed-perturb", action="store_true")
    parser.add_argument("--use-pydub-augment", action="store_true")
    parser.add_argument("--use-roll-augment", action="store_true")
    parser.add_argument("--black-list-csv", default=None)
    parser.add_argument("--early-stop", type=int, default=None)
    parser.add_argument("--eval-interval", type=int, default=5000)
    parser.add_argument("--checkpoint-interval", type=int, default=5000)
    parser.add_argument("--eval-batch-size", type=int, default=256)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--workspace", default="./workspace")
    parser.add_argument("--resume-iteration", type=int, default=0)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--f32-ingest", action="store_true",
                        help="ship float32 waveforms to the card instead of int16 PCM "
                             "decoded there (the int16 default halves the bytes and trains "
                             "to the same parameters)")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 trunk compute")
    parser.add_argument("--block-impl", default="xla", choices=["xla", "xla_approx"],
                        help="block tail: 'xla' = exact erf GELU (the reference training "
                             "recipe); 'xla_approx' = tanh GELU")
    parser.add_argument("--remat-blocks", action="store_true",
                        help="recompute the unfused blocks in the backward "
                             "(torch.utils.checkpoint): less memory, one more block "
                             "forward per backward")
    parser.add_argument("--fused-train-blocks", action="store_true",
                        help="run stages 3-4 through the fused block kernels (K1 save mode "
                             "forward, K2 backward); needs --block-impl xla_approx")
    parser.add_argument("--frontend-precision", default=None,
                        choices=["highest", "high", "default"],
                        help="DFT/mel product precision; default 'high' with --bf16, "
                             "else 'highest' (true f32)")
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU")
    return parser.parse_args(argv)


def train(args: argparse.Namespace, train_index: dict, eval_indexes: Dict[str, dict],
          train_dataset, eval_dataset=None,
          on_step: Optional[Callable[[int, float], None]] = None):
    """The training run of ``args`` (from :func:`parse_args`): the sampler
    over ``train_index`` (``data.load_index``'s dict), batches of
    ``train_dataset`` (meta -> {'waveform', 'target', ...}), an evaluation
    of each of ``eval_indexes`` ({'bal'|'test': index}) over
    ``eval_dataset`` every ``--eval-interval`` steps, checkpoints, the
    statistics and the metric log. ``on_step(iteration, loss)`` goes to
    ``Trainer.train``. Returns the trainer. A process group that this call
    joined from the environment is left again at its end; one the caller
    joined stays."""
    import torch
    import torch.distributed

    from audioset_convnext_inf_torch.checkpoint import (
        load_checkpoint,
        load_reference_state_dict,
        save_checkpoint,
        state_dict_from_jax_params,
        to_tensors,
    )
    from audioset_convnext_inf_torch.config import FrontendConfig
    from audioset_convnext_inf_torch.data import (
        AlternateTrainSampler,
        BalancedTrainSampler,
        DataLoader,
        EvaluateSampler,
        TrainSampler,
    )
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator
    from audioset_convnext_inf_torch.engine.metrics import summarize
    from audioset_convnext_inf_torch.engine.statistics import StatisticsContainer
    from audioset_convnext_inf_torch.engine.trainer import TrainConfig, Trainer
    from audioset_convnext_inf_torch.models import create_model
    from audioset_convnext_inf_torch.models.api import resolve_device
    from audioset_convnext_inf_torch.parallel import get_mesh, initialize_distributed, is_primary
    from audioset_convnext_inf_torch.utils import MetricLogger, create_logging
    from audioset_convnext_inf_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    device = resolve_device(args.device)
    mesh = metrics_logger = None
    started = not torch.distributed.is_initialized()
    try:
        if initialize_distributed(device=device):
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            mesh = get_mesh([device])
        primary = is_primary()
        if primary:
            create_logging(os.path.join(args.workspace, "logs", args.model))
            metrics_logger = MetricLogger(
                run_name=f"{args.model}-bs{args.batch_size}",
                out_dir=os.path.join(args.workspace, "metrics", args.model),
                config=vars(args),
            )
        fe_precision = args.frontend_precision or ("high" if args.bf16 else "highest")
        model = create_model(
            args.model,
            drop_path_rate=args.drop_path_rate,
            after_stem_dim=tuple(args.after_stem_dim),
            use_speed_perturb=args.use_speed_perturb,
            use_pydub_augment=args.use_pydub_augment,
            use_roll_augment=args.use_roll_augment,
            seed=args.seed,
            block_impl=args.block_impl,
            remat_blocks=args.remat_blocks,
            fused_train_blocks=args.fused_train_blocks,
            frontend=FrontendConfig(
                precision=fe_precision, sample_rate=args.sample_rate,
                n_fft=args.window_size, win_length=args.window_size,
                hop_length=args.hop_size, n_mels=args.mel_bins,
                fmin=args.fmin, fmax=args.fmax),
            device=device,
        )
        cfg = model.cfg
        logging.info("model %s: %d params", args.model, model.count_parameters())
        train_cfg = TrainConfig(
            optimizer=args.optimizer,
            max_lr=args.max_lr,
            total_steps=args.total_steps,
            weight_decay=args.weight_decay,
            use_wd_schedule=args.use_wd_scheduler,
            accumulation_steps=args.accumulation_steps,
            mixup_alpha=args.mixup_alpha,
            seed=args.seed,
            bf16_compute=args.bf16,
        )
        sampler_cls = {
            "uniform": TrainSampler,
            "balanced": BalancedTrainSampler,
            "alternate": AlternateTrainSampler,
        }[args.sampler]
        # mixup needs pairs: sample twice the batch (reference main.py:556-575)
        sample_batch = args.batch_size * (2 if args.mixup_alpha > 0 else 1)
        sampler = sampler_cls.from_index(train_index, sample_batch, args.black_list_csv,
                                         args.seed)
        ckpt_root = os.path.join(args.workspace, "checkpoints", args.model)
        statistics = StatisticsContainer(
            os.path.join(args.workspace, "statistics", args.model, "statistics.pkl"))
        trainer = Trainer(model, train_cfg, mesh=mesh)

        if args.resume_iteration:
            ck = load_checkpoint(os.path.join(ckpt_root, f"{args.resume_iteration}_iterations"))
            params = load_reference_state_dict(state_dict_from_jax_params(ck["params"]), cfg)
            trainer.restore(to_tensors(params), ck["opt_state"], ck["iteration"])
            if ck.get("sampler_state") is not None:
                sampler.load_state_dict(ck["sampler_state"])
                # a checkpoint taken before the first resumed step saves this
                # snapshot again, not the live sampler the loader ran ahead
                trainer.last_sampler_state = ck["sampler_state"]
            try:
                statistics.load_state_dict(args.resume_iteration)
            except FileNotFoundError:
                pass
            logging.info("resumed at iteration %d", ck["iteration"])

        loader = DataLoader(train_dataset, sampler if mesh is None else RankRows(sampler, mesh),
                            num_workers=args.num_workers)
        # the evaluator runs the trainer's own model, in eval mode, between
        # steps, on the primary only; the other ranks wait in their next
        # all-reduce (the process group's timeout outlasts an evaluation)
        evaluator = Evaluator(model, device=device) if eval_indexes and primary else None

        def eval_fn(_model, iteration: int) -> None:
            for tag, index in eval_indexes.items():
                eloader = DataLoader(eval_dataset,
                                     EvaluateSampler.from_index(index, args.eval_batch_size),
                                     num_workers=args.num_workers,
                                     pad_to_batch_size=args.eval_batch_size)
                s = summarize(evaluator.evaluate(eloader))
                logging.info("iter %d %s mAP %.4f AUC %.4f d' %.4f", iteration, tag,
                             s["mAP"], s["mAUC"], s["dprime"])
                statistics.append(iteration, s, tag)
                metrics_logger.log({f"{tag}/{k}": v for k, v in s.items()}, step=iteration)
            statistics.dump()

        def checkpoint_fn(tr, iteration: int) -> None:
            if not primary:
                return
            # the loader runs the sampler ahead of training: save the snapshot
            # that came with the last consumed batch (exact resume)
            state = tr.last_sampler_state
            save_checkpoint(
                os.path.join(ckpt_root, f"{iteration}_iterations"),
                tr.model.state_dict(),
                cfg,
                opt_state=tr.optimizer.state_dict(),
                sampler_state=state if state is not None else sampler.state_dict(),
                iteration=iteration,
            )
            logging.info("checkpoint saved at iteration %d", iteration)

        trainer.train(
            loader,
            eval_fn=eval_fn if evaluator is not None else None,
            eval_interval=args.eval_interval,
            checkpoint_fn=checkpoint_fn,
            checkpoint_interval=args.checkpoint_interval,
            early_stop=args.early_stop,
            on_step=on_step,
        )
        checkpoint_fn(trainer, trainer.step_index)
    finally:
        if metrics_logger is not None:
            metrics_logger.finish()
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return trainer


class RankRows:
    """A batch sampler yielding this rank's rows of each of ``sampler``'s
    batches, so that each rank's loader reads only its own clips; its state
    is the wrapped sampler's, the global one (the same on every rank)."""

    def __init__(self, sampler, mesh):
        self.sampler, self.mesh = sampler, mesh

    def __iter__(self):
        from audioset_convnext_inf_torch.parallel import batch_sharding

        for metas in self.sampler:
            yield metas[batch_sharding(self.mesh, len(metas))]

    def state_dict(self):
        return self.sampler.state_dict()


def main(argv=None) -> int:
    args = parse_args(argv)
    from audioset_convnext_inf_torch.data import AudioSetDataset, load_index
    from audioset_convnext_inf_torch.models.api import resolve_device

    resolve_device(args.device)  # no card and no --device: fail before reading data
    eval_indexes = {tag: load_index(path) for tag, path in (("bal", args.bal_indexes),
                                                            ("test", args.eval_indexes)) if path}
    train(args, load_index(args.train_indexes), eval_indexes,
          AudioSetDataset(training=True, keep_int16=not args.f32_ingest), AudioSetDataset())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
