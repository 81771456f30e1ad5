#!/usr/bin/env python3
"""Same-card A/B of the fused-block kernels between checkouts.

    python3 scripts/ab_fused_block_torch.py DIR_A DIR_B [DIR ...]

Each DIR is the root of a checkout of this repo, for example a parent
commit unpacked with ``git archive`` into the git-ignored ``build/``. The
script builds each checkout's kernels in that checkout, then times K2 and
K1 (serving and save mode) in bf16 at the main path's shapes (tiny stage 3
and 4, B=16), each the median of 5 runs of 20 calls by CUDA events, one
child process per checkout, in the order A B ... B A, so that a drift of
the card over the run falls on every checkout alike (name a checkout
twice for more rounds: A B B A gives A B B A A B B A). The children use each checkout's own wrappers and
chip_smoke.py helpers. Each child also keeps K1's d (save mode) at both
shapes, and the last line says whether every checkout's d is bit-equal to
the first's. Prints one JSON line per child and, last, one JSON object with
the card, each checkout's mean times and that comparison.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD = """
import sys
sys.path.insert(0, ".")
from audioset_convnext_inf_torch.ops import _build
for name in ("fused_block", "fused_block_bwd"):
    _build.build(name)
"""

TIME = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from audioset_convnext_inf_torch.ops.fused_block import fused_block
from audioset_convnext_inf_torch.ops.fused_block_bwd import fused_block_bwd
dev, out, ds = torch.device("cuda"), {}, {}
for name, b, h, w, c, _ in cs.K1_CASES[:2]:
    xb, d, dy, wts, sb = cs.k2_inputs(b, h, w, c, torch.bfloat16, dev, cs.SEED)
    out[name + " k2"] = cs.median_ms(lambda: fused_block_bwd(xb, d, dy, *wts, sb), iters=20)[0]
    x, args = cs.k1_inputs(b, h, w, c, True, torch.bfloat16, dev, cs.SEED)
    s = cs.drop_scales(b, dev, cs.SEED)
    out[name] = cs.median_ms(lambda: fused_block(x, *args), iters=20)[0]
    out[name + " save"] = cs.median_ms(
        lambda: fused_block(x, *args, 1e-6, s=s, save_dwconv=True), iters=20)[0]
    ds[name] = fused_block(x, *args, 1e-6, s=s, save_dwconv=True)[1].cpu()
torch.save(ds, sys.argv[1])
print(json.dumps(out))
"""


def run(code: str, tree: Path, *args) -> str:
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tree, capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{tree}: {proc.stderr[-3000:]}")
    return proc.stdout


def main(argv) -> int:
    trees = [Path(a).resolve() for a in argv]
    if len(trees) < 2 or not all((t / "chip_smoke.py").is_file() for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs  # this checkout's, for the card's name and limit

    card = cs.power_line()
    print(card, flush=True)
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        list(pool.map(lambda t: run(BUILD, t), trees))
    import torch

    times = {str(t): [] for t in trees}
    d_files = {str(t): t / "build" / "ab_fused_block_d.pt" for t in trees}
    for t in trees + trees[::-1]:
        d_files[str(t)].parent.mkdir(exist_ok=True)
        row = json.loads(run(TIME, t, str(d_files[str(t)])).strip().splitlines()[-1])
        times[str(t)].append(row)
        print(json.dumps({"tree": str(t), "ms": row}), flush=True)
    mean = {t: {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
            for t, rows in times.items()}
    first = torch.load(d_files[str(trees[0])])
    d_equal = {str(t): {k: bool(torch.equal(first[k], v)) for k, v in torch.load(f).items()}
               for t, f in d_files.items()}
    print(json.dumps({"card": card, "mean_ms": mean, "d_bit_equal_to_first": d_equal}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
