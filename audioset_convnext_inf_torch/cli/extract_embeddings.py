"""Per-file logit or embedding extraction (reference extract_embeddings.py).

    python -m audioset_convnext_inf_torch.cli.extract_embeddings \\
        --checkpoint ckpt --out embeddings.h5 [--kind logits|scene] \\
        [--device cpu|cuda] DIR_OR_WAVS...

Walks directories for .wav files (sorted), forwards each, and stores one
vector per file id in the output HDF5 (needs h5py). Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("inputs", nargs="+", help="wav files or directories")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--kind", default="logits", choices=["logits", "scene"])
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU")
    args = parser.parse_args(argv)

    from audioset_convnext_inf_torch.engine.infer import extract_embeddings_to_hdf5
    from audioset_convnext_inf_torch.models import ConvNeXt, convnext_tiny
    from audioset_convnext_inf_torch.models.api import resolve_device

    paths = []
    for inp in args.inputs:
        if os.path.isdir(inp):
            for root, _, files in os.walk(inp):
                paths.extend(os.path.join(root, f) for f in sorted(files) if f.endswith(".wav"))
        else:
            paths.append(inp)

    device = resolve_device(args.device)
    if args.checkpoint:
        model = ConvNeXt.from_pretrained(args.checkpoint, device=device)
    else:
        model = convnext_tiny(drop_path_rate=0.0, device=device)
        print("WARNING: no checkpoint given - using random weights")

    n = extract_embeddings_to_hdf5(model, paths, args.out, kind=args.kind)
    print(f"wrote {n}/{len(paths)} vectors to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
