"""Dataset packing CLI (reference utils/dataset.py), the port's counterpart of
the JAX package's ``cli/pack_dataset.py``. Host-only: it needs h5py and no
card.

    # pack the clips of an AudioSet CSV found in DIR into one HDF5
    python -m audioset_convnext_inf_torch.cli.pack_dataset pack \\
        --csv meta.csv --audios-dir DIR --out packed.h5 [--mini-data N] [--audio-ext .flac]

    # the index file the samplers read
    python -m audioset_convnext_inf_torch.cli.pack_dataset index \\
        --waveforms packed.h5 --out indexes.h5

    # one index over several
    python -m audioset_convnext_inf_torch.cli.pack_dataset combine \\
        --indexes a.h5 b.h5 --out full.h5

    # split the unbalanced CSV into 50k-row parts
    python -m audioset_convnext_inf_torch.cli.pack_dataset split \\
        --csv unbalanced_train_segments.csv --out-dir parts/

    # a training blacklist of YouTube ids from DCASE2017-task4 segment CSVs
    # (reference utils/create_black_list.py)
    python -m audioset_convnext_inf_torch.cli.pack_dataset blacklist \\
        --csvs testing_set.csv evaluation_set.csv --out black_list.csv
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pack")
    p.add_argument("--csv", required=True)
    p.add_argument("--audios-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mini-data", type=int, default=0)
    p.add_argument("--audio-ext", default=".wav")

    p = sub.add_parser("index")
    p.add_argument("--waveforms", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("combine")
    p.add_argument("--indexes", nargs="+", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("split")
    p.add_argument("--csv", required=True)
    p.add_argument("--out-dir", required=True)

    p = sub.add_parser("blacklist")
    p.add_argument("--csvs", nargs="+", required=True,
                   help="DCASE2017-task4 segment CSVs (the first column is a segment "
                        "file name; the bare YouTube id is taken from it)")
    p.add_argument("--out", required=True)

    args = parser.parse_args(argv)

    from audioset_convnext_inf_torch.data import blacklist, pack

    if args.cmd == "pack":
        out = pack.pack_waveforms_to_hdf5(args.csv, args.audios_dir, args.out,
                                          mini_data=args.mini_data, audio_ext=args.audio_ext)
    elif args.cmd == "index":
        out = pack.create_indexes(args.waveforms, args.out)
    elif args.cmd == "combine":
        out = pack.combine_indexes(args.indexes, args.out)
    elif args.cmd == "blacklist":
        out = blacklist.write_black_list(blacklist.dcase2017_task4_ids(args.csvs), args.out)
    else:
        out = pack.split_unbalanced_csv_to_partial_csvs(args.csv, args.out_dir)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
