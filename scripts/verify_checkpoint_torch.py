#!/usr/bin/env python
"""Checkpoint-arrival gate of the PyTorch port: one command that holds a
published convnext_tiny checkpoint to the reference's own acceptance
evidence, on the card unless ``--device cpu`` is given.

Usage:
    python scripts/verify_checkpoint_torch.py convnext_tiny_471mAP.pth \\
        [--wav tests/fixtures/f62-S-v2swA_200000_210000.wav] \\
        [--eval-indexes eval_indexes.h5] [--bf16] [--device cpu]

Checks, in order (those of scripts/verify_checkpoint.py):
 1. parameter count 28,222,767 (README.md:49, demo_convnext.sbatch.output:3)
 2. golden demo prediction on the checked-in sample: indexes
    [0 137 138 139 151 506] at threshold 0.25
    (scripts/demo_convnext.sbatch.output:10); with --bf16, the bf16
    serving config too
 3. output shapes (1,527) / scene (1,768) / frame (1,768,31,7)
 4. optionally, AudioSet eval mAP/AUC vs the published 0.471 / 0.973
    (README.md:32-38) over the clips of an eval index HDF5
    (AudioSetDataset, EvaluateSampler, DataLoader, Evaluator; needs h5py).

The checkpoint is a local .pth, .safetensors or native checkpoint
directory, loaded strictly by ``ConvNeXt.from_pretrained``; nothing is
downloaded. Exit code 0 = every requested check passed; 1 = a check
failed or the checkpoint did not load.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_INDEXES = [0, 137, 138, 139, 151, 506]
GOLDEN_PARAMS = 28_222_767
PUBLISHED = {"mAP": 0.471, "mAUC": 0.973, "dprime": 3.071}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint", help="local .pth / .safetensors file or native checkpoint "
                                       "directory")
    ap.add_argument("--wav", default="tests/fixtures/f62-S-v2swA_200000_210000.wav")
    ap.add_argument("--threshold", type=float, default=0.25)
    ap.add_argument("--eval-indexes", default=None, help="eval index HDF5 for mAP check")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--map-tolerance", type=float, default=0.002)
    ap.add_argument("--bf16", action="store_true", help="also verify the bf16 serving path")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to ask for the CPU")
    args = ap.parse_args(argv)

    import torch
    from scipy.io import wavfile

    from audioset_convnext_inf_torch.device import resolve_device
    from audioset_convnext_inf_torch.models import ConvNeXt
    from audioset_convnext_inf_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    device = resolve_device(args.device)
    failures = []

    def check(name, ok, detail=""):
        print(f"[{'PASS' if ok else 'FAIL'}] {name}{': ' + detail if detail else ''}", flush=True)
        if not ok:
            failures.append(name)

    if not os.path.exists(args.checkpoint):
        check("load checkpoint", False, f"{args.checkpoint!r} is not a local file or directory")
        return 1
    try:
        model = ConvNeXt.from_pretrained(args.checkpoint, device=device)
    except (KeyError, ValueError, RuntimeError, OSError) as e:
        check("load checkpoint", False, f"{type(e).__name__}: {e}")
        return 1

    # 1. parameter count
    n = model.count_parameters()
    check("param count", n == GOLDEN_PARAMS, f"{n:,} (want {GOLDEN_PARAMS:,})")

    # 2/3. golden demo prediction + shapes
    sr, data = wavfile.read(args.wav)
    wav = (data / 32768.0).astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    wav = np.pad(wav, (0, max(0, 320000 - len(wav))))[None, :320000]

    models = [("f32", model)]
    if args.bf16:  # the serving config: tanh GELU, fused stage-3/4 kernel, frontend "default"
        serve = ConvNeXt(model.cfg, compute_dtype=torch.bfloat16, device=device)
        serve.load_state_dict(model.state_dict(), strict=True)
        models.append(("bf16", serve))
    for tag, m in models:
        probs = m.forward(wav)["clipwise_output"].float().cpu().numpy()
        check(f"logits shape ({tag})", probs.shape == (1, 527), str(probs.shape))
        pred = np.where(probs[0] > args.threshold)[0].tolist()
        check(f"golden demo indexes ({tag})", pred == GOLDEN_INDEXES,
              f"{pred} (want {GOLDEN_INDEXES})")
    scene = tuple(model.forward_scene_embeddings(wav).shape)
    frame = tuple(model.forward_frame_embeddings(wav).shape)
    check("scene embedding shape", scene == (1, 768), str(scene))
    check("frame embedding shape", frame == (1, 768, 31, 7), str(frame))

    # 4. eval-set metric parity
    if args.eval_indexes:
        from audioset_convnext_inf_torch.data import AudioSetDataset, DataLoader, EvaluateSampler
        from audioset_convnext_inf_torch.engine.evaluator import Evaluator
        from audioset_convnext_inf_torch.engine.metrics import summarize

        loader = DataLoader(AudioSetDataset(keep_int16=True),
                            EvaluateSampler(args.eval_indexes, args.batch_size), num_workers=8)
        m = model
        if args.bf16:
            # as scripts/verify_checkpoint.py evaluates bf16: the tanh-GELU
            # blocks (fused stage-3/4 kernel), the checkpoint's own frontend
            cfg_eval = model.cfg
            if cfg_eval.block_impl == "xla":
                cfg_eval = dataclasses.replace(cfg_eval, block_impl="xla_approx")
            m = ConvNeXt(cfg_eval, compute_dtype=torch.bfloat16, auto_fast_serving=False,
                         device=device)
            m.load_state_dict(model.state_dict(), strict=True)
        s = summarize(Evaluator(m, device=device).evaluate(loader))
        print(f"eval: mAP={s['mAP']:.4f} mAUC={s['mAUC']:.4f} d'={s['dprime']:.4f}")
        check("published mAP", abs(s["mAP"] - PUBLISHED["mAP"]) <= args.map_tolerance,
              f"{s['mAP']:.4f} vs {PUBLISHED['mAP']} (tol {args.map_tolerance})")
        check("published AUC", abs(s["mAUC"] - PUBLISHED["mAUC"]) <= 0.002, f"{s['mAUC']:.4f}")

    print("\n" + ("ALL CHECKS PASSED" if not failures else f"FAILED: {failures}"))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
