"""Checkpoint conversion (reference convert_pytorch_ckpt_to_safetensors.py).

    python -m audioset_convnext_inf_torch.cli.convert IN OUT \\
        [--to safetensors|native] [--model NAME] [--device cpu|cuda]

IN: a .pth, a .safetensors file or a native checkpoint directory. OUT: a
safetensors file or a native checkpoint directory (which the JAX package
also reads). A native directory carries its own config.json, which is used
as it is; flat files carry none, so ``--model`` names their architecture.
The weights are checked (keys, shapes, the mel matrix) and written on the
host; no model is built. ``--device`` is resolved as every CLI's is (the
card by default), so the command raises without a card unless asked for
the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--to", default="safetensors", choices=["safetensors", "native"])
    parser.add_argument("--model", default=None,
                        help="factory name for flat inputs with no embedded "
                             "config (default: convnext_tiny)")
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU "
                             "(conversion itself runs on the host)")
    args = parser.parse_args(argv)

    from audioset_convnext_inf_torch.checkpoint import (
        load_checkpoint,
        load_pretrained,
        load_reference_state_dict,
        save_checkpoint,
        save_safetensors,
        state_dict_from_jax_params,
    )
    from audioset_convnext_inf_torch.models.api import resolve_device

    resolve_device(args.device)
    if os.path.isdir(args.input):
        # a native checkpoint: its config.json is authoritative
        state = load_checkpoint(args.input)
        cfg = state.get("config") or _cfg_from_model_arg(args.model, args.input)
        sd = load_reference_state_dict(state_dict_from_jax_params(state["params"]), cfg)
    else:
        cfg = _cfg_from_model_arg(args.model, args.input)
        sd = load_pretrained(args.input, cfg)
    if args.to == "safetensors":
        save_safetensors(sd, args.output)
    else:
        save_checkpoint(args.output, sd, cfg)
    print(f"converted {args.input} -> {args.output} ({args.to})")
    return 0


def _cfg_from_model_arg(model, input_path: str):
    from audioset_convnext_inf_torch.config import ConvNeXtConfig
    from audioset_convnext_inf_torch.models.api import _VARIANTS

    if model is None:
        logging.warning("%s carries no config; assuming convnext_tiny (pass --model to "
                        "override)", input_path)
        return ConvNeXtConfig(drop_path_rate=0.0)
    if model not in _VARIANTS:
        raise KeyError(f"unknown model {model!r}; available: {sorted(_VARIANTS)}")
    depths, dims = _VARIANTS[model]
    return ConvNeXtConfig(name=model, depths=depths, dims=dims, drop_path_rate=0.0)


if __name__ == "__main__":
    raise SystemExit(main())
