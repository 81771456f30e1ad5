"""The port's tagging service against the JAX package's.

The batcher (``engine/service.py``) of both packages gets the numpy fake
models of ``tests/test_service.py`` and must behave alike: batching to
``batch_size``, ``max_wait_ms`` closing a partial batch, int16 staying int16
with ``pcm_int16``, overload, ``stop()``, a failing batch. A slab-reuse case
checks every result of many threads against its own clip. The port's HTTP
service (``cli/serve.py``, on the CPU, a tiny trunk) answers ``/tag`` and
``/embed`` as the JAX package's ``ConvNeXt`` computes them on the same
weights and inputs.
"""

import io
import json
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.engine import infer as JI
from audioset_convnext_inf_tpu.engine import service as JS
from audioset_convnext_inf_tpu.models import api as jax_api

from audioset_convnext_inf_torch.checkpoint import state_dict_from_jax_params, to_tensors
from audioset_convnext_inf_torch.cli import serve
from audioset_convnext_inf_torch.config import CLIP_SAMPLES, INT16_SCALE, ConvNeXtConfig
from audioset_convnext_inf_torch.engine import service as S
from audioset_convnext_inf_torch.models import ConvNeXt

from tests.test_torch_checkpoint import _port_init
from tests.test_torch_model import _randomize

IMPLS = {"jax": JS, "port": S}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CountingModel:
    """Records forward batch sizes; each row's output is its mean |x|."""

    def __init__(self):
        self.batches = []

    def forward(self, wav):
        self.batches.append(wav.shape[0])
        probs = np.tile(np.abs(wav).mean(axis=1, keepdims=True), (1, 527))
        return {"clipwise_output": probs, "clipwise_logits": probs}


class _DtypeRecordingModel:
    """Records the dtype of each forward batch; decodes int16 as the card does."""

    def __init__(self):
        self.dtypes = []

    def forward(self, wav):
        self.dtypes.append(wav.dtype)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) * np.float32(INT16_SCALE)
        probs = np.tile(np.abs(wav).mean(axis=1, keepdims=True), (1, 527))
        return {"clipwise_output": probs, "clipwise_logits": probs}


class _EchoModel:
    """Each row's output is its first two samples, then zeros."""

    def forward(self, wav):
        out = np.zeros((wav.shape[0], 527), np.float32)
        out[:, :2] = wav[:, :2]
        return {"clipwise_output": out, "clipwise_logits": -out}


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_batches_to_batch_size(impl):
    """8 clips submitted together coalesce into few batches; each result is
    its own clip's; a short clip is zero-padded to clip_samples."""
    model = _CountingModel()
    with IMPLS[impl].InferenceService(model, batch_size=8, max_wait_ms=100,
                                      clip_samples=100) as svc:
        futs = [svc.submit(np.full(100, i / 10, np.float32)) for i in range(8)]
        results = [f.result(timeout=10) for f in futs]
        half = svc.tag(np.ones(50, np.float32), timeout=10)
    for i, r in enumerate(results):
        np.testing.assert_allclose(r["clipwise_output"][0], i / 10, atol=1e-6)
    np.testing.assert_allclose(half["clipwise_output"][0], 0.5, atol=1e-6)
    assert svc.stats["requests"] == 9 and svc.stats["clips"] == 9
    assert svc.stats["batches"] <= 4
    assert set(model.batches) == {8}  # the warm-up and every batch: one shape


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_max_wait_closes_a_partial_batch(impl):
    """3 clips for a batch of 16: the batch closes after max_wait_ms, not
    when it fills."""
    model = _CountingModel()
    with IMPLS[impl].InferenceService(model, batch_size=16, max_wait_ms=30,
                                      clip_samples=64) as svc:
        t0 = time.monotonic()
        futs = [svc.submit(np.full(64, 0.25, np.float32)) for _ in range(3)]
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=10)["clipwise_output"][0], 0.25)
        waited = time.monotonic() - t0
    assert svc.stats["batches"] >= 1 and svc.stats["clips"] == 3
    assert waited < 5.0


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_int16_stays_int16_with_pcm_int16(impl):
    """An all-int16 batch reaches the model as int16; the results equal the
    float32 submission of the decoded clip; warm-up: float32, then int16."""
    model = _DtypeRecordingModel()
    with IMPLS[impl].InferenceService(model, batch_size=4, max_wait_ms=50, clip_samples=100,
                                      pcm_int16=True) as svc:
        res16 = [f.result(timeout=10) for f in
                 [svc.submit(np.full(100, 16384, np.int16)) for _ in range(4)]]
        out32 = svc.tag(np.full(100, 16384.0 / 32767.0, np.float32), timeout=10)
    assert model.dtypes[:2] == [np.float32, np.int16]
    assert np.dtype(np.int16) in model.dtypes[2:]
    np.testing.assert_allclose(res16[0]["clipwise_output"], out32["clipwise_output"], atol=1e-6)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_int16_without_pcm_int16_and_mixed_batches_decode_on_the_host(impl):
    model = _DtypeRecordingModel()
    svc = IMPLS[impl].InferenceService(model, batch_size=2, max_wait_ms=200, clip_samples=100)
    svc.start()
    try:
        f1 = svc.submit(np.full(100, 16384, np.int16))
        f2 = svc.submit(np.full(100, 0.5, np.float32))
        r1, r2 = f1.result(timeout=10), f2.result(timeout=10)
    finally:
        svc.stop()
    assert all(d == np.float32 for d in model.dtypes)
    np.testing.assert_allclose(r1["clipwise_output"][0], 16384.0 / 32767.0, atol=1e-6)
    np.testing.assert_allclose(r2["clipwise_output"][0], 0.5, atol=1e-6)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_max_queued_overload(impl):
    """A full queue raises ServiceOverloaded and counts the rejection; the
    accepted clips still complete."""
    release = threading.Event()

    class _BlockingModel:
        def forward(self, wav):
            if wav.max() > 0:  # the warm-up batch of zeros passes
                release.wait(timeout=30)
            v = np.ones((wav.shape[0], 527), np.float32) * 0.5
            return {"clipwise_output": v, "clipwise_logits": v}

    mod = IMPLS[impl]
    svc = mod.InferenceService(_BlockingModel(), batch_size=2, max_wait_ms=1, clip_samples=8,
                               max_queued=4).start()
    try:
        futs = [svc.submit(np.full(8, 0.5, np.float32)) for _ in range(4)]
        with pytest.raises(mod.ServiceOverloaded):
            for _ in range(12):
                futs.append(svc.submit(np.full(8, 0.5, np.float32)))
        assert svc.stats["rejected"] >= 1
        release.set()
        for f in futs:
            assert f.result(timeout=30)["clipwise_output"].shape == (527,)
    finally:
        release.set()
        svc.stop()


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_stop_fails_queued_futures(impl):
    class _SlowModel:
        def forward(self, wav):
            time.sleep(0.2)
            p = np.zeros((wav.shape[0], 527), np.float32)
            return {"clipwise_output": p, "clipwise_logits": p}

    mod = IMPLS[impl]
    svc = mod.InferenceService(_SlowModel(), batch_size=2, max_wait_ms=1,
                               clip_samples=100).start()
    futs = [svc.submit(np.zeros(100, np.float32)) for _ in range(12)]
    t0 = time.monotonic()
    svc.stop()
    outcomes = []
    for f in futs:
        try:
            f.result(timeout=5)
            outcomes.append("ok")
        except mod.ServiceStopped:
            outcomes.append("stopped")
    assert time.monotonic() - t0 < 10
    assert "stopped" in outcomes
    with pytest.raises(mod.ServiceStopped):
        svc.submit(np.zeros(100, np.float32))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_a_failing_batch_does_not_stop_the_service(impl):
    class _FlakyModel:
        def __init__(self):
            self.calls = 0

        def forward(self, wav):
            self.calls += 1
            if self.calls == 2:  # the first call is the warm-up
                raise RuntimeError("boom")
            p = np.zeros((wav.shape[0], 527), np.float32)
            return {"clipwise_output": p, "clipwise_logits": p}

    with IMPLS[impl].InferenceService(_FlakyModel(), batch_size=2, max_wait_ms=5,
                                      clip_samples=10) as svc:
        with pytest.raises(RuntimeError, match="boom"):
            svc.tag(np.ones(10, np.float32), timeout=10)
        assert svc.tag(np.ones(10, np.float32), timeout=10)["clipwise_output"].shape == (527,)


@pytest.fixture
def _fast_thread_switches():
    """Switch threads every 10 us, so lost updates and slab races show."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("pcm_int16", [False, True])
def test_slabs_reused_under_many_threads_give_each_clip_its_own_result(pcm_int16,
                                                                      _fast_thread_switches):
    """800 distinct clips from 8 threads through batches of 4 (two slabs
    per dtype, rewritten hundreds of times): every future holds its own
    clip's result, as the JAX service gives it, and the counters lose no
    update."""
    results = {}
    for impl in sorted(IMPLS):
        with IMPLS[impl].InferenceService(_EchoModel(), batch_size=4, max_wait_ms=2,
                                          clip_samples=16, pcm_int16=pcm_int16,
                                          max_queued=1000) as svc:
            def client(t):
                out = []
                for k in range(100):
                    i = t * 100 + k
                    clip = (np.array([i, -i] + [7] * 14, np.int16) if pcm_int16
                            else np.array([i, -i] + [7] * 14, np.float32))
                    out.append((i, svc.submit(clip)))
                return [(i, f.result(timeout=30)) for i, f in out]

            with ThreadPoolExecutor(8) as pool:
                got = [r for rs in pool.map(client, range(8)) for r in rs]
        assert svc.stats["requests"] == svc.stats["clips"] == 800
        assert svc.stats["batches"] >= 200
        for i, r in got:  # int16 batches reach the model undecoded
            np.testing.assert_array_equal(r["clipwise_output"][:2], np.array([i, -i], np.float32))
        results[impl] = {i: r["clipwise_output"] for i, r in got}
    for i in results["jax"]:
        np.testing.assert_array_equal(results["port"][i], results["jax"][i])


# ---------------------------------------------------------------------------
# The HTTP service against the JAX package's forward
# ---------------------------------------------------------------------------

TINY = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), drop_path_rate=0.0)


@pytest.fixture(scope="module")
def server():
    """The port's server on a free port (CPU, f32, batch 2) and the JAX
    model, on the same seeded weights."""
    params = _randomize(_port_init(ConvNeXtConfig(**TINY), 0), np.random.RandomState(31))
    model = ConvNeXt(ConvNeXtConfig(**TINY), device="cpu")
    model.load_state_dict(to_tensors(state_dict_from_jax_params(params)), strict=True)
    jm = jax_api.ConvNeXt(JaxConfig(**TINY), jax.tree_util.tree_map(jnp.asarray, params))
    srv, service = serve.make_server(["--port", "0", "--batch-size", "2", "--max-wait-ms", "5",
                                      "--dtype", "float32", "--device", "cpu"], model=model)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service, jm
    srv.shutdown()
    srv.server_close()
    service.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body, content_type):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _wav_bytes(pcm):
    buf = io.BytesIO()
    wavfile.write(buf, 32000, pcm)
    return buf.getvalue()


def test_http_service_matches_jax(server):
    """/tag for float32, raw int16 and WAV bodies and a 25-s body, /embed
    and /healthz, against the JAX package's forward on the same clips."""
    url, service, jm = server
    rng = np.random.RandomState(5)
    f32 = (rng.randn(40000) * 0.1).astype(np.float32)  # 1.25 s: padded to 10 s
    i16 = np.clip(np.round(rng.randn(CLIP_SAMPLES) * 3000), -32768, 32767).astype("<i2")
    wav16 = np.clip(np.round(rng.randn(64000) * 2000), -32768, 32767).astype(np.int16)
    long = (rng.randn(800000) * 0.1).astype(np.float32)  # 25 s: 3 windows

    windows, n = JI.sliding_windows(long)
    assert n == 3
    clips = np.zeros((3 + n, CLIP_SAMPLES), np.float32)
    clips[0, :len(f32)] = f32
    clips[1] = i16.astype(np.float32) * np.float32(INT16_SCALE)  # the card's decode
    clips[2, :len(wav16)] = wav16.astype(np.float32) * np.float32(INT16_SCALE)
    clips[3:] = windows
    ref = np.asarray(jm.forward(clips)["clipwise_output"])
    emb_ref = np.asarray(jm.forward_scene_embeddings(clips[:1]))[0]

    bodies = [(f32.tobytes(), "application/octet-stream", ref[0]),
              (i16.tobytes(), "application/pcm-int16", ref[1]),
              (_wav_bytes(wav16), "audio/wav", ref[2]),
              (long.tobytes(), "application/octet-stream", ref[3:].max(axis=0))]
    before = service.counters()
    for body, content_type, want in bodies:
        out = _post(url + "/tag", body, content_type)
        top = np.argsort(want)[::-1][:10]
        assert out["indexes"] == [int(i) for i in top], content_type
        np.testing.assert_allclose(out["probs"], want[top], atol=1e-4, rtol=0)
        assert len(out["labels"]) == 10
    assert out["num_windows"] == 3
    emb = _post(url + "/embed", f32.tobytes(), "application/octet-stream")["embedding"]
    np.testing.assert_allclose(emb, emb_ref, atol=2e-4, rtol=0)
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.load(r)
    assert health["status"] == "ok"
    assert health["requests"] - before["requests"] == 6  # 3 clips and 3 windows; not /embed
    assert health["clips"] - before["clips"] == 6 and health["batches"] > before["batches"]


def test_http_errors(server):
    """An unknown path is 404, an undecodable body 400."""
    url, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/nope", b"\0" * 8, "application/octet-stream")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/tag", b"RIFF-not-a-wav", "audio/wav")
    assert e.value.code == 400


def test_http_overload_is_429(monkeypatch, server):
    url, service, _ = server

    def full(_wav):
        raise S.ServiceOverloaded("request queue full")

    monkeypatch.setattr(service, "submit", full)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/tag", np.zeros(100, np.float32).tobytes(), "application/octet-stream")
    assert e.value.code == 429


def test_serve_bundle_answers_as_the_bundle(tmp_path):
    """cli/serve.py --bundle serves an AOT bundle (10-s clips, int16 in)
    with no live model: --batch-size is clamped to the largest bucket, each
    /tag answer is the bundle's own forward, /embed its scene program;
    --bundle with --mesh is an argument error, and a bundle does not serve
    on another device type."""
    from audioset_convnext_inf_torch.engine.aot_export import BundleModel, save_bundle

    path = str(tmp_path / "bundle")
    save_bundle(ConvNeXt(ConvNeXtConfig(**TINY), device="cpu"), path, batch_sizes=(2,),
                kinds=("forward", "scene"), pcm=True)
    with pytest.raises(SystemExit):
        serve.parse_args(["--bundle", path, "--mesh"])
    with pytest.raises(ValueError, match="exported for cpu"):
        serve.make_server(["--port", "0", "--bundle", path, "--device", "cuda"])
    srv, service = serve.make_server(["--port", "0", "--bundle", path, "--batch-size", "8",
                                      "--max-wait-ms", "5", "--device", "cpu"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        assert isinstance(service.model, BundleModel) and service.batch_size == 2
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        pcm = np.clip(np.round(np.random.RandomState(8).randn(CLIP_SAMPLES) * 3000),
                      -32768, 32767).astype("<i2")
        bundle = service.model.bundle
        want = bundle(pcm[None])["clipwise_output"][0].numpy()
        out = _post(url + "/tag", pcm.tobytes(), "application/pcm-int16")
        top = np.argsort(want)[::-1][:10]
        assert out["indexes"] == [int(i) for i in top]
        np.testing.assert_array_equal(np.float32(out["probs"]), want[top])
        emb = _post(url + "/embed", pcm.tobytes(), "application/pcm-int16")["embedding"]
        np.testing.assert_array_equal(np.float32(emb), bundle(pcm[None], kind="scene")[0].numpy())
    finally:
        srv.shutdown()
        srv.server_close()
        service.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
