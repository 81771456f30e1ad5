"""The PANN eval routes of the port against the benchmark's plain reference
(``benchmark/reference/pann.py``, float32, TF32 off, nothing of the port),
at the published widths of Wavegram-Logmel-CNN14 on short clips, with the
benchmark's seeded weights (``benchmark/reference/pann_weights.py``: every
BatchNorm drawn away from the identity, so that every layer reaches the
answer). Also the int16 wire, the spans and route counters, the Evaluator
and ``cli/evaluate.py --model`` on a PANN. The bf16 route on the card, at
the cell's clip length, is in ``tests/test_torch_cuda.py``.

Tolerances on the probabilities:
 - f32 route: 5e-5. Measured 1.8e-7-2.1e-7 here: the port folds each eval
   BatchNorm into one scale and shift, the reference divides by the
   standard deviation; the rest is summation order.
 - bf16 route: 0.01. Measured 0.0016-0.0020 here (the CPU rounds each
   convolution's output, then its ReLU) and 0.0024-0.0034 on the card at
   10 s and B=256 (the benchmark's ``prob_gap``); the same reference with
   float8 (e4m3) products reads 0.028-0.060 here and 0.164-0.181 on the
   card, so a route one precision below bf16 fails it.
"""

import json

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch.cli import evaluate
from audioset_convnext_inf_torch.config import INT16_SCALE
from audioset_convnext_inf_torch.data.loader import DataLoader
from audioset_convnext_inf_torch.engine.evaluator import Evaluator
from audioset_convnext_inf_torch.models import pann as PM
from audioset_convnext_inf_torch.models import pann_layers as PL
from benchmark import clips
from benchmark.reference import pann as ref
from benchmark.reference.pann_weights import make_state_dict
from benchmark.spec import HERE
from tests.make_synth_hdf5 import make_packed_and_index

NAME = "Wavegram_Logmel_Cnn14"
SAMPLES = 32000  # 1 s: both branches reach conv_block6 with 3 x 2 bins
F32_TOL, BF16_TOL = 5e-5, 1e-2
SPANS = ["model.frontend", "model.wavegram", "model.trunk", "model.head"]

with open(HERE / "configs" / "wavegram_logmel_cnn14-bf16-serve.json") as f:
    MCFG = json.load(f)["model"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(sd, dtype=torch.float32, name=NAME):
    model = PM.create_pann_model(name, device="cpu", compute_dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model


def _pcm(seed, n=2, samples=SAMPLES):
    return clips.pool(seed, n, samples)


def _gap(model, sd, pcm, quant=None):
    got = model.forward(pcm)["clipwise_output"].float()
    want = ref.probabilities(sd, torch.from_numpy(pcm), MCFG, quant=quant)
    return float((got - want).abs().max())


@pytest.mark.parametrize("seed", [11, 2**31 + 17])
def test_f32_route_matches_the_reference(seed):
    sd = make_state_dict(MCFG, seed, "cpu")
    model = _model(sd)
    pcm = _pcm(seed)
    probs = model.forward(pcm)["clipwise_output"]
    # the weights reach the answer: probabilities spread, clips told apart
    assert probs.std() > 0.02 and (probs[0] - probs[1]).abs().max() > 0.01
    assert _gap(model, sd, pcm) < F32_TOL


@pytest.mark.parametrize("seed", [12, 2**31 + 19])
def test_bf16_route_matches_the_reference_and_float8_does_not(seed):
    sd = make_state_dict(MCFG, seed, "cpu")
    model = _model(sd, torch.bfloat16)
    pcm = _pcm(seed)
    assert model.frontend.cfg.precision == "default"
    assert _gap(model, sd, pcm) < BF16_TOL
    # the control: the reference with float8 products in the program's place
    f8 = ref.probabilities(sd, torch.from_numpy(pcm), MCFG, quant=torch.float8_e4m3fn)
    want = ref.probabilities(sd, torch.from_numpy(pcm), MCFG)
    assert float((f8 - want).abs().max()) > BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int16_decodes_on_the_models_device(dtype):
    """An int16 batch and its float decode (x * 1/32767 in f32) give the
    same probabilities; before, int16 was cast unscaled, 32768 times too
    loud."""
    sd = make_state_dict(MCFG, 13, "cpu")
    model = _model(sd, dtype)
    pcm = _pcm(13)
    got = model.forward(pcm)["clipwise_output"]
    want = model.forward(torch.from_numpy(pcm).float() * INT16_SCALE)["clipwise_output"]
    assert torch.equal(got, want)


def test_spans_and_route_counters(tmp_path):
    """Each route opens the model's spans under a running profiler, and
    each forward counts once on its own route."""
    sd = make_state_dict(MCFG, 14, "cpu")
    pcm = _pcm(14)
    for dtype, attr in ((torch.float32, "f32_forwards"), (torch.bfloat16, "bf16_forwards")):
        model = _model(sd, dtype)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            model.forward(pcm)
        path = tmp_path / f"{attr}.json"
        prof.export_chrome_trace(str(path))
        names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
        assert set(SPANS) <= names, (dtype, sorted(n for n in names if n.startswith("model.")))
        model.forward(pcm)
        other = "bf16_forwards" if attr == "f32_forwards" else "f32_forwards"
        assert (getattr(model, attr), getattr(model, other)) == (2, 0)


def test_cnn14_bf16_route_against_its_f32_route():
    """Cnn14 shares the route's pieces (frontend, ConvBlock, head): its bf16
    route against its own f32 route, with every BatchNorm drawn away from
    the identity."""
    model = PM.create_pann_model("Cnn14", device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, PL.BatchNorm) and mod is not model.bn0:
                n = mod.weight.shape[0]
                mod.weight.copy_(torch.rand(n, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(n, generator=g) * 0.1)
                mod.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
        model.bn0.running_mean.fill_(-30.0)
        model.bn0.running_var.fill_(150.0)
    serve = PM.create_pann_model("Cnn14", device="cpu", compute_dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict(), strict=True)
    pcm = _pcm(15)
    want = model.forward(pcm)["clipwise_output"]
    got = serve.forward(pcm)["clipwise_output"]
    assert float((got - want).abs().max()) < BF16_TOL


@pytest.mark.parametrize("name", ["Cnn6", "Cnn14Sep", "Cnn14Deformable", "ResNet22",
                                  "MobileNetV1"])
def test_bf16_is_refused_where_the_family_has_no_route(name):
    with pytest.raises(ValueError, match="no bf16 route"):
        PM.create_pann_model(name, device="cpu", compute_dtype=torch.bfloat16)


def test_serve_pool_matches_torchs_pools():
    x = torch.randn(2, 8, 7, 5).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    avg = PL.serve_pool(x, (2, 2))
    assert torch.allclose(avg.float(), torch.nn.functional.avg_pool2d(x.float(), 2), atol=1e-2)
    assert avg.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(PL.serve_pool(x, (1, 2), "max"), torch.nn.functional.max_pool2d(x, (1, 2)))
    assert PL.serve_pool(x, (1, 1)) is x


class _Memory:
    def __init__(self, pcm):
        self.pcm = pcm

    def __getitem__(self, meta):
        i = meta["index_in_hdf5"]
        return {"audio_name": str(i), "waveform": self.pcm[i],
                "target": np.zeros(527, np.float32)}


@pytest.mark.parametrize("pin", [False, True])
def test_evaluator_runs_the_bf16_route_over_the_loader(pin):
    """int16 clips cross the DataLoader and the Evaluator as int16; the
    answers are the model's own, in the loader's order. With ``pin_memory``
    the loader's workers stack each numeric field into a CPU tensor (pinned
    where a card is), the last batch padded with zeros, and the answers
    are the same."""
    sd = make_state_dict(MCFG, 16, "cpu")
    model = _model(sd, torch.bfloat16)
    pcm = _pcm(16, n=5)
    batches = [[{"index_in_hdf5": i} for i in b] for b in ([3, 1], [0, 4], [2])]
    loader = DataLoader(_Memory(pcm), batches, num_workers=2, pad_to_batch_size=2,
                        pin_memory=pin)
    last = list(loader)[-1]
    assert isinstance(last["waveform"], torch.Tensor) == pin
    assert last["valid"] == 1 and last["waveform"].shape == (2, SAMPLES)
    assert (np.asarray(last["waveform"][1]) == 0).all()
    assert np.array_equal(np.asarray(last["waveform"][0]), pcm[2])
    out = Evaluator(model, device="cpu").infer_probs(loader)
    want = model.forward(pcm[[3, 1, 0, 4, 2]])["clipwise_output"].numpy()
    assert out["clipwise_output"].shape == (5, 527)
    np.testing.assert_allclose(out["clipwise_output"], want, atol=1e-6)
    assert model.bf16_forwards == 4 and model.f32_forwards == 0


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_evaluate_cli_names_a_pann(tmp_path, capsys, monkeypatch, dtype, tol):
    """``cli/evaluate.py --model Wavegram_Logmel_Cnn14`` on a seeded
    reference-keyed checkpoint (``torch.save``, under ``"model"``) and a
    synthetic HDF5 pair: the published parameter count, the metric lines,
    and every clip's probabilities against the reference on its int16
    waveform."""
    _, index = make_packed_and_index(str(tmp_path / "h5"), n_clips=6, clip_samples=SAMPLES,
                                     seed=5)
    sd = make_state_dict(MCFG, 17, "cpu")
    ck = tmp_path / "wlcnn14.pth"
    torch.save({"model": sd}, ck)
    seen = []
    forward = PM.PannModel.forward

    def recorded(self, x):
        out = forward(self, x)
        assert str(self.compute_dtype) == f"torch.{dtype}"
        seen.append((torch.as_tensor(x).clone(), out["clipwise_output"].float()))
        return out

    monkeypatch.setattr(PM.PannModel, "forward", recorded)
    assert evaluate.main(["--checkpoint", str(ck), "--model", NAME, "--eval-indexes", index,
                          "--batch-size", "2", "--num-workers", "1", "--keep-int16",
                          "--dtype", dtype, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"# params: {MCFG['parameters']}"
    assert lines[1].startswith("Eval: mAP: ")
    x = torch.cat([x for x, _ in seen])
    assert x.dtype == torch.int16 and x.shape[1] == SAMPLES
    assert x.shape[0] == 6
    got = torch.cat([p for _, p in seen])
    want = ref.probabilities(sd, x, MCFG)
    assert float((got - want).abs().max()) < tol


def test_folded_weights_follow_every_change_of_the_weights():
    """The bf16 route folds each BatchNorm once and keeps the result: a
    load_state_dict, an in-place change of a statistic and a copy of the
    model each give the answers of a model built afresh."""
    sd = make_state_dict(MCFG, 19, "cpu")
    model = _model(sd, torch.bfloat16)
    pcm = _pcm(19)
    first = model.forward(pcm)["clipwise_output"]
    other = make_state_dict(MCFG, 20, "cpu")
    model.load_state_dict(other, strict=True)
    assert torch.equal(model.forward(pcm)["clipwise_output"],
                       _model(other, torch.bfloat16).forward(pcm)["clipwise_output"])
    with torch.no_grad():
        model.conv_block3.bn2.running_var.mul_(4.0)
    fresh = _model(model.state_dict(), torch.bfloat16)
    assert torch.equal(model.forward(pcm)["clipwise_output"],
                       fresh.forward(pcm)["clipwise_output"])
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.forward(pcm)["clipwise_output"], first)
