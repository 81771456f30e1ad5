"""Single-file tagging demo (reference demo_convnext.py).

    python -m audioset_convnext_inf_torch.cli.demo AUDIO.wav \\
        [--checkpoint PATH_OR_HF_ID] [--threshold 0.25] [--long-audio] \\
        [--device cpu|cuda]

Prints the parameter count, the logits and probabilities shapes, the labels
above the activity threshold and the scene and frame embedding shapes: the
reference's golden surface (scripts/demo_convnext.sbatch.output). Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("audio", help="path to an audio file (wav)")
    parser.add_argument("--checkpoint", default=None,
                        help="local .pth/.safetensors/native dir, https URL, or HF id; "
                             "omit for random weights (pipeline demo)")
    parser.add_argument("--threshold", type=float, default=0.25)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--long-audio", action="store_true",
                        help="tag arbitrary-length audio with 10-s sliding "
                             "windows (max-reduced) instead of crop/pad")
    parser.add_argument("--window-hop-seconds", type=float, default=10.0)
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU")
    args = parser.parse_args(argv)

    from audioset_convnext_inf_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from audioset_convnext_inf_torch.engine.infer import load_clip, tag_clip, tag_long_audio
    from audioset_convnext_inf_torch.models import ConvNeXt, convnext_tiny
    from audioset_convnext_inf_torch.models.api import resolve_device

    device = resolve_device(args.device)
    if args.checkpoint:
        model = ConvNeXt.from_pretrained(args.checkpoint, device=device)
        print(f"Loaded ckpt from: {args.checkpoint}")
    else:
        model = convnext_tiny(drop_path_rate=0.0, seed=args.seed, device=device)
        print("WARNING: no checkpoint given - using random weights")
    print(f"# params: {model.count_parameters()}")

    print(f"\nInference on: {args.audio}\n")
    if args.long_audio:
        from audioset_convnext_inf_torch.config import SAMPLE_RATE
        from audioset_convnext_inf_torch.data.audio_io import read_wav
        from audioset_convnext_inf_torch.labels import read_audioset_label_tags

        wav, _ = read_wav(args.audio, target_sr=SAMPLE_RATE)
        out = tag_long_audio(model, wav, hop_samples=int(args.window_hop_seconds * SAMPLE_RATE))
        probs = out["clipwise_output"]
        idx = np.where(probs > args.threshold)[0]
        lm = read_audioset_label_tags()
        print(f"windows: {out['windowwise_output'].shape[0]}")
        print(np.array(idx))
        for i in idx:
            print(f"  {i:4d}  {lm.ix_to_lb[int(i)]}  p={probs[i]:.3f}")
        return 0
    clip = load_clip(args.audio)

    result = tag_clip(model, clip, threshold=args.threshold)
    print(f"logits size: {(1,) + result['logits'].shape}")
    print(f"probs size: {(1,) + result['probs'].shape}")
    print(f"Predicted labels using activity threshold {args.threshold}:\n")
    print(np.array(result["indexes"]))
    for ix, lb in zip(result["indexes"], result["labels"]):
        print(f"  {ix:4d}  {lb}  p={result['probs'][ix]:.3f}")

    scene = model.forward_scene_embeddings(clip)
    print(f"\nScene embedding, shape: {tuple(scene.shape)}")
    frame = model.forward_frame_embeddings(clip)
    print(f"\nFrame-level embeddings, shape: {tuple(frame.shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
