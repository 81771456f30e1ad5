"""Export an AOT serving bundle (``torch.export`` programs, weights inside).

    python -m audioset_convnext_inf_torch.cli.export_serving OUT_DIR \\
        [--model convnext_tiny] [--checkpoint PATH] [--dtype float32|bfloat16] \\
        [--batch-sizes 1,16,32,128] [--kinds forward,scene,frame] [--pcm] \\
        [--num-samples N] [--weights baked|shared] [--device cpu|cuda]

The bundle needs no model code at serve time: load it with
``engine.aot_export.load_bundle`` and call it, or serve it with
``cli.serve --bundle OUT_DIR``. Export on the device you will serve on
(default: the card; ``--device cpu`` asks for the CPU): a bundle serves only
on the device type it was exported on, and on the card it carries the
fused block kernel's library. See engine/aot_export.py.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("out_dir")
    parser.add_argument("--model", default="convnext_tiny")
    parser.add_argument("--checkpoint", default=None,
                        help="local .pth/.safetensors/native checkpoint; random weights if "
                             "omitted (smoke tests)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--batch-sizes", default="1,16,32,128",
                        help="comma-separated fixed buckets; add 'dynamic' for one program "
                             "that takes any batch")
    parser.add_argument("--kinds", default="forward")
    parser.add_argument("--pcm", action="store_true", help="export the int16-PCM entry point")
    parser.add_argument("--num-samples", type=int, default=None,
                        help="input samples per clip (default: 320000)")
    parser.add_argument("--weights", default="baked", choices=["baked", "shared"],
                        help="'baked' puts the weights in every program; 'shared' stores them "
                             "once in params.npz (smaller bundles with many buckets)")
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU")
    args = parser.parse_args(argv)

    import torch

    from audioset_convnext_inf_torch.config import CLIP_SAMPLES
    from audioset_convnext_inf_torch.engine.aot_export import save_bundle
    from audioset_convnext_inf_torch.models.api import ConvNeXt, create_model, resolve_device

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.checkpoint:
        model = ConvNeXt.from_pretrained(args.checkpoint, compute_dtype=dtype, device=device)
    else:
        model = create_model(args.model, drop_path_rate=0.0, compute_dtype=dtype, device=device)
    manifest = save_bundle(
        model,
        args.out_dir,
        batch_sizes=[b if b == "dynamic" else int(b) for b in args.batch_sizes.split(",")],
        kinds=[k.strip() for k in args.kinds.split(",")],
        pcm=args.pcm,
        num_samples=args.num_samples or CLIP_SAMPLES,
        weights=args.weights,
    )
    print(f"exported {len(manifest['entries'])} programs -> {args.out_dir} "
          f"({manifest['input_dtype']} input, device {manifest['device']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
