"""AudioCaps transfer fine-tuning CLI (reference finetune_audiocaps.py).

    python -m audioset_convnext_inf_torch.cli.finetune_audiocaps \\
        --root DATA_ROOT [--checkpoint Cnn14.pth] [--epochs 19] \\
        [--batch-size 64] [--lr 1e-4] [--out-dir audiocaps_ckpts] [--device cpu]

The port's counterpart of the JAX package's ``cli/finetune_audiocaps.py``,
with the same flags and ``--device`` (default: the card). Expects
<root>/AUDIOCAPS_32000Hz/{train,val,test}.csv (+ optional
<subset>_tags.csv) and audio under audio/<subset>/ (``data/audiocaps.py``).
A Cnn14 base, from a reference-keyed ``.pth`` (``load_pann_state_dict``) or
random without one, frozen but fc1/fc_audioset; BCE loss, AMSGrad
(``engine/transfer.py``). After each epoch it writes
``<out-dir>/model_epoch_XXXX_mAP_Y``, a native checkpoint in the JAX
package's PANN layout that its ``load_checkpoint`` reads, named by the val
mAP. Batches are read and decoded serially, as the JAX CLI reads them.
"""

from __future__ import annotations

import argparse
import logging
import os


def _loader(dataset, collate, batch_size):
    def gen():
        batch = []
        for i in range(len(dataset)):
            batch.append(dataset[i])
            if len(batch) == batch_size:
                yield collate(batch)
                batch = []
        if batch:
            yield collate(batch)

    return gen


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", required=True)
    parser.add_argument("--checkpoint", default=None, help="pretrained Cnn14 .pth")
    parser.add_argument("--epochs", type=int, default=19)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--eval-batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--out-dir", default="audiocaps_ckpts")
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to ask for the CPU")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    import torch

    from audioset_convnext_inf_torch.checkpoint import load_pann_state_dict, save_checkpoint
    from audioset_convnext_inf_torch.data.audiocaps import AudioCaps, BasicCollate
    from audioset_convnext_inf_torch.engine.transfer import TransferTrainer
    from audioset_convnext_inf_torch.models.pann import create_pann_model

    model = create_pann_model("Cnn14", device=args.device)
    if args.checkpoint:
        blob = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
        if isinstance(blob, dict) and "model" in blob:
            blob = blob["model"]
        load_pann_state_dict(model, blob)
        logging.info("loaded pretrained base from %s", args.checkpoint)
    else:
        logging.warning("no checkpoint - finetuning a random base")

    datasets = {
        s: AudioCaps(root=args.root, subset=s, download=False, with_tags=True)
        for s in ("train", "val", "test")
    }
    collate = BasicCollate(with_tags=True)

    trainer = TransferTrainer(model, learning_rate=args.lr)

    def checkpoint_fn(epoch, mAP):
        os.makedirs(args.out_dir, exist_ok=True)
        save_checkpoint(
            os.path.join(args.out_dir, f"model_epoch_{epoch:04d}_mAP_{mAP:.4f}"),
            trainer.model.state_dict(),
            cfg=trainer.model.cfg,
            iteration=epoch,
        )

    trainer.fit(
        _loader(datasets["train"], collate, args.batch_size),
        _loader(datasets["val"], collate, args.eval_batch_size),
        _loader(datasets["test"], collate, args.eval_batch_size),
        epochs=args.epochs,
        checkpoint_fn=checkpoint_fn,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
