"""Legacy inference CLI over the PANN zoo (reference pytorch/inference.py).

    # top-10 clipwise tags
    python -m audioset_convnext_inf_torch.cli.inference audio_tagging \\
        --audio-path x.wav --model-type Cnn14 [--checkpoint ck.pth] [--device cpu]

    # framewise sound event detection (DecisionLevel* models)
    python -m audioset_convnext_inf_torch.cli.inference sound_event_detection \\
        --audio-path x.wav --model-type Cnn14_DecisionLevelMax \\
        [--checkpoint ck.pth] [--out-csv events.csv] [--plot sed.png]

Runs on the card unless ``--device cpu`` is given. A checkpoint is a
reference-keyed state dict (``torch.load(weights_only=True)``, optionally
under ``"model"``), loaded by ``checkpoint.pann_convert.load_pann_state_dict``;
without one the weights are random. Model dispatch goes through the
registry instead of ``eval(model_type)`` (inference.py:47). SED results are
a CSV of (frame, class, prob) maxima and/or the reference's two-panel
figure (log spectrogram over the top-k framewise heatmap,
inference.py:172-196) with ``--plot`` (matplotlib, imported only then).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _load_model(model_type: str, checkpoint: str | None, device):
    from audioset_convnext_inf_torch.checkpoint.pann_convert import load_pann_state_dict
    from audioset_convnext_inf_torch.models.pann import create_pann_model

    model = create_pann_model(model_type, device=device)
    if checkpoint:
        blob = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if isinstance(blob, dict) and "model" in blob:
            blob = blob["model"]
        load_pann_state_dict(model, blob)
    else:
        print("WARNING: no checkpoint given - using random weights")
    return model


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="mode", required=True)
    for mode in ("audio_tagging", "sound_event_detection"):
        p = sub.add_parser(mode)
        p.add_argument("--audio-path", required=True)
        p.add_argument("--model-type", default="Cnn14")
        p.add_argument("--checkpoint", default=None)
        p.add_argument("--top-k", type=int, default=10)
        p.add_argument("--out-csv", default=None)
        p.add_argument("--plot", default=None, help="save the SED figure (png)")
        p.add_argument("--device", default=None,
                       help="default: the card; 'cpu' to ask for the CPU")
    args = parser.parse_args(argv)

    from audioset_convnext_inf_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from audioset_convnext_inf_torch.data.audio_io import read_wav
    from audioset_convnext_inf_torch.device import resolve_device
    from audioset_convnext_inf_torch.labels import read_audioset_label_tags

    model = _load_model(args.model_type, args.checkpoint, resolve_device(args.device))
    frontend_cfg = model.cfg.frontend
    wav, _ = read_wav(args.audio_path, target_sr=frontend_cfg.sample_rate)
    out = model.forward(wav[None, :].astype(np.float32))
    lm = read_audioset_label_tags()

    if args.mode == "audio_tagging":
        probs = out["clipwise_output"][0].cpu().numpy()
        order = np.argsort(probs)[::-1][: args.top_k]
        for ix in order:
            print(f"{lm.ix_to_lb[int(ix)]}: {probs[ix]:.3f}")
        return 0
    if "framewise_output" not in out:
        raise SystemExit(
            f"{args.model_type} has no framewise output; use a Cnn14_DecisionLevel* model")
    framewise = out["framewise_output"][0].cpu().numpy()  # (T, 527)
    top = np.argsort(framewise.max(axis=0))[::-1][: args.top_k]
    print(f"framewise output: {framewise.shape}")
    for ix in top:
        print(f"{lm.ix_to_lb[int(ix)]}: max frame prob {framewise[:, ix].max():.3f}")
    if args.out_csv:
        import csv

        with open(args.out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["frame", "class_index", "label", "prob"])
            for ix in top:
                fr = int(framewise[:, ix].argmax())
                w.writerow([fr, int(ix), lm.ix_to_lb[int(ix)], float(framewise[fr, ix])])
        print(f"wrote {args.out_csv}")
    if args.plot:
        plot_sed(wav.astype(np.float32), framewise, top, lm, frontend_cfg, args.plot)
        print(f"saved SED figure to {args.plot}")
    return 0


def plot_sed(wav, framewise, top_indexes, label_maps, frontend_cfg, fig_path):
    """Two-panel SED figure (reference inference.py:172-196): log-magnitude
    spectrogram on top, top-k framewise probabilities below, tick labels in
    seconds / class names."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from audioset_convnext_inf_torch.ops.frontend import power_spectrogram

    power = power_spectrogram(torch.from_numpy(wav)[None, :], frontend_cfg)[0].numpy()  # (T, F)
    log_stft = 0.5 * np.log(np.maximum(power, 1e-20))  # log|STFT| = log(power)/2
    frames_num = log_stft.shape[0]
    frames_per_second = frontend_cfg.sample_rate // frontend_cfg.hop_length
    top_result_mat = framewise[:, top_indexes]  # (T, top_k)

    fig, axs = plt.subplots(2, 1, sharex=True, figsize=(10, 4))
    axs[0].matshow(log_stft.T, origin="lower", aspect="auto", cmap="jet")
    axs[0].set_ylabel("Frequency bins")
    axs[0].set_title("Log spectrogram")
    axs[1].matshow(
        top_result_mat.T, origin="upper", aspect="auto", cmap="jet", vmin=0, vmax=1
    )
    axs[1].xaxis.set_ticks(np.arange(0, frames_num, frames_per_second))
    axs[1].xaxis.set_ticklabels(np.arange(0, frames_num / frames_per_second).astype(int))
    axs[1].yaxis.set_ticks(np.arange(0, len(top_indexes)))
    axs[1].yaxis.set_ticklabels([label_maps.ix_to_lb[int(i)] for i in top_indexes])
    axs[1].yaxis.grid(color="k", linestyle="solid", linewidth=0.3, alpha=0.3)
    axs[1].set_xlabel("Seconds")
    axs[1].xaxis.set_ticks_position("bottom")
    plt.tight_layout()
    plt.savefig(fig_path)
    plt.close(fig)


if __name__ == "__main__":
    raise SystemExit(main())
