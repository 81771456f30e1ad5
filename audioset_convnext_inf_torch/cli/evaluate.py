"""AudioSet batch evaluation (reference evaluate_convnext_on_audioset.py).

    python -m audioset_convnext_inf_torch.cli.evaluate \\
        --checkpoint ckpt.safetensors \\
        --eval-indexes eval_indexes.h5 [--bal-indexes bal_indexes.h5] \\
        [--batch-size 256] [--num-workers 10] [--dtype bfloat16] \\
        [--keep-int16] [--device cpu|cuda]

The published protocol: a batched forward over the balanced-train and eval
HDF5 index sets; prints mAP / AUC / d-prime per subset. Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--eval-indexes", required=True)
    parser.add_argument("--bal-indexes", default=None)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--num-workers", type=int, default=10)
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--keep-int16", action="store_true",
                        help="ship packed int16 to the card and decode it there "
                             "(half the host-to-card bytes; identical probabilities)")
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU")
    args = parser.parse_args(argv)

    from audioset_convnext_inf_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import torch

    from audioset_convnext_inf_torch.data import AudioSetDataset, DataLoader, EvaluateSampler
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator
    from audioset_convnext_inf_torch.engine.metrics import summarize
    from audioset_convnext_inf_torch.models import ConvNeXt
    from audioset_convnext_inf_torch.models.api import resolve_device

    device = resolve_device(args.device)
    model = ConvNeXt.from_pretrained(
        args.checkpoint,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=device,
    )
    print(f"# params: {model.count_parameters()}")
    evaluator = Evaluator(model, device=device)

    def run(tag: str, index_path: str) -> None:
        loader = DataLoader(
            AudioSetDataset(keep_int16=args.keep_int16),
            EvaluateSampler(index_path, args.batch_size),
            num_workers=args.num_workers,
            pad_to_batch_size=args.batch_size,
        )
        t0 = time.time()
        s = summarize(evaluator.evaluate(loader))
        print(
            f"{tag}: mAP: {s['mAP']:.6f}, AUC: {s['mAUC']:.6f}, "
            f"d-prime: {s['dprime']:.6f}  ({time.time() - t0:.1f}s)"
        )

    if args.bal_indexes:
        run("Balanced train", args.bal_indexes)
    run("Eval", args.eval_indexes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
