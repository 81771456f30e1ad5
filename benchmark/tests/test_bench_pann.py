"""The PANN cell's plumbing on the CPU: the seeded weights against the
port's state dict, the published parameter count, the operation counts
against a hand count, the reference's isolation from the program, and a
short run of ``wlcnn14-eval-b256`` at 1-s clips (sound: correct; an altered
answer: not correct)."""

import subprocess
import sys

import numpy as np

from benchmark import counts_pann, program_pann, run, spec
from benchmark.reference.pann_weights import make_state_dict, param_table

CELL = "wlcnn14-eval-b256"


def _cell(**traffic):
    cell = spec.cell(spec.load(), CELL)
    return cell._replace(traffic=dict(cell.traffic, **traffic))


def test_state_dict_matches_the_ports_keys_shapes_and_count():
    cfg = _cell().config
    sd = make_state_dict(cfg["model"], 3, "cpu")
    theirs = program_pann.build_model(cfg, sd, "cpu").state_dict()
    assert list(sd) == list(theirs) == [k for k, _, _ in param_table(cfg["model"])]
    assert all(sd[k].shape == theirs[k].shape for k in sd)
    n = sum(v.numel() for k, v in sd.items() if "running" not in k)
    assert n == cfg["model"]["parameters"] == 81065487


def test_counts_against_a_hand_count():
    m = _cell().config["model"]
    macs = counts_pann.macs(m, 320000)
    # conv_block2: 128 -> 128 channels at 500 x 32 (after the concat), two 3x3 convs
    assert macs["conv_block2"] == 500 * 32 * 128 * (128 + 128) * 9
    # pre_block1: two k-3 convs of 64 channels over 64,000 samples
    assert macs["pre_block1"] == 64000 * 64 * 128 * 3
    # conv_block1: 1 -> 64 -> 64 channels over 1001 frames x 64 mels
    assert macs["conv_block1"] == 1001 * 64 * 64 * 65 * 9
    assert 25.6e9 < sum(macs.values()) < 25.7e9


def test_the_reference_loads_with_the_program_blocked():
    code = ("import sys\nsys.modules['audioset_convnext_inf_torch'] = None\n"
            "import benchmark.reference.pann, benchmark.reference.pann_weights\nprint('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(spec.REPO), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


def test_a_short_run_is_correct_and_an_altered_answer_is_not(tmp_path):
    cell = _cell(batch=2, pool_clips=6, samples=32000, check_clips=4, check_block=2,
                 trace_after=1, trace_batches=1)
    ok = run.execute(cell, 2**31 + 7, 1.0, True, device="cpu", workdir=tmp_path)
    assert ok["correct"] and ok["attempted"] > 0 and ok["failed"] == 0
    assert {"eval.loader_wait_share", "mfu.eval_wlcnn14"} <= set(ok["metrics"])

    def alter(probs):
        probs = probs.copy()
        probs[:, 3] = 0.0
        return probs

    bad = run.execute(cell, 2**31 + 7, 1.0, False, device="cpu", faults={"eval_answers": alter},
                      workdir=tmp_path)
    assert not bad["correct"]
    assert bad["checks"]["prob_gap"]["value"] > bad["checks"]["prob_gap"]["limit"]
    assert np.isfinite(bad["metrics"]["eval_clips_per_s"]["value"])
