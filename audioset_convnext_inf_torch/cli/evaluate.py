"""AudioSet batch evaluation (reference evaluate_convnext_on_audioset.py).

    python -m audioset_convnext_inf_torch.cli.evaluate \\
        --checkpoint ckpt.safetensors \\
        --eval-indexes eval_indexes.h5 [--bal-indexes bal_indexes.h5] \\
        [--model convnext_tiny|convnext_base|Wavegram_Logmel_Cnn14|...] \\
        [--batch-size 256] [--num-workers 10] [--dtype bfloat16] \\
        [--keep-int16] [--device cpu|cuda]

The published protocol: a batched forward over the balanced-train and eval
HDF5 index sets; prints mAP / AUC / d-prime per subset. Runs on the card
unless ``--device cpu`` is given. ``--model`` names an audio ConvNeXt
(``convnext_tiny``, the default, to ``convnext_base``; its checkpoint as
``ConvNeXt.from_pretrained`` reads it) or a PANN of
``models.pann.PANN_REGISTRY``, whose checkpoint
is a reference-keyed state dict (``torch.load(weights_only=True)``,
optionally under ``"model"``, as ``cli/inference.py`` reads it) loaded by
``checkpoint.pann_convert.load_pann_state_dict``. ``--dtype bfloat16``
selects the bf16 serving route of either.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--model", default="convnext_tiny",
                        help="a ConvNeXt (default convnext_tiny) or a PANN such as "
                             "Wavegram_Logmel_Cnn14")
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

    from audioset_convnext_inf_torch.config import ConvNeXtConfig
    from audioset_convnext_inf_torch.data import AudioSetDataset, DataLoader, EvaluateSampler
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator
    from audioset_convnext_inf_torch.engine.metrics import summarize
    from audioset_convnext_inf_torch.models import ConvNeXt
    from audioset_convnext_inf_torch.models.api import _VARIANTS, resolve_device
    from audioset_convnext_inf_torch.models.pann import PANN_REGISTRY

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.model in PANN_REGISTRY:
        model = _pann_model(args.model, args.checkpoint, dtype, device)
    else:
        if args.model not in _VARIANTS:
            parser.error(f"unknown --model {args.model!r}: a ConvNeXt ({', '.join(_VARIANTS)}) "
                         f"or a PANN of models.pann.PANN_REGISTRY")
        depths, dims = _VARIANTS[args.model]
        cfg = ConvNeXtConfig(name=args.model, depths=depths, dims=dims, drop_path_rate=0.0,
                             after_stem_dim=(252, 56))
        model = ConvNeXt.from_pretrained(args.checkpoint, compute_dtype=dtype, cfg=cfg,
                                         device=device)
    print(f"# params: {model.count_parameters()}")
    evaluator = Evaluator(model, device=device)

    def run(tag: str, index_path: str) -> None:
        loader = DataLoader(
            AudioSetDataset(keep_int16=args.keep_int16),
            EvaluateSampler(index_path, args.batch_size),
            num_workers=args.num_workers,
            pad_to_batch_size=args.batch_size,
            pin_memory=device.type == "cuda",
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


def _pann_model(name: str, checkpoint: str, dtype, device):
    import torch

    from audioset_convnext_inf_torch.checkpoint.pann_convert import load_pann_state_dict
    from audioset_convnext_inf_torch.models.pann import create_pann_model

    model = create_pann_model(name, device=device, compute_dtype=dtype)
    blob = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return load_pann_state_dict(model, blob.get("model", blob))


if __name__ == "__main__":
    raise SystemExit(main())
