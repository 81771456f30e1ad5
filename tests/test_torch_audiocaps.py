"""The port's AudioCaps dataset (``data/audiocaps.py``) against the JAX
package's, on one fixture root of FLAC clips (``tests/flac_encoder.py``):
every case of ``tests/test_audiocaps.py``'s dataset, collate, command and
download-pipeline tests, run on both packages with equal results. The
clips decode through each package's own FLAC decoder (the port's build of
``csrc/flac_decode.cpp``, the JAX package's native library), bit-equal."""

import numpy as np
import pytest

from audioset_convnext_inf_tpu.data import audiocaps as JA
from audioset_convnext_inf_tpu.utils import native

from audioset_convnext_inf_torch.data import audiocaps as TA

PACKAGES = {"port": TA, "jax": JA}


@pytest.fixture(scope="module")
def audiocaps_root(tmp_path_factory):
    """tests/test_audiocaps.py's root: 4 clips on disk per subset (train,
    val), lengths 16000-19000, 1 and 5 captions, a fifth clip listed but
    missing, tags for each."""
    from tests.flac_encoder import encode_flac

    assert native.available(), "native/libaudiohost.so is not built"
    root = tmp_path_factory.mktemp("ac_root")
    data = root / "AUDIOCAPS_32000Hz"
    rng = np.random.RandomState(0)
    for subset, caps_per in (("train", 1), ("val", 5)):
        audio_dir = data / "audio" / subset
        audio_dir.mkdir(parents=True)
        lines = ["audiocap_id,youtube_id,start_time,caption\n"]
        for i in range(4):
            ytid = f"yt{subset}{i:04d}"
            for c in range(caps_per):
                lines.append(f"{i * 10 + c},{ytid},10,a caption number {c}\n")
            n = 16000 + 1000 * i
            (audio_dir / f"{ytid}_10.flac").write_bytes(
                encode_flac((rng.randn(n) * 2000).astype(np.int64), 32000))
        lines.extend(f"{90 + c},ytmissing00,10,a caption number {c}\n" for c in range(caps_per))
        (data / f"{subset}.csv").write_text("".join(lines))
        tag_lines = ["youtube_id,mids\n"] + [
            f"yt{subset}{i:04d},/m/09x0r;/m/05zppz\n" for i in range(4)]
        (data / f"{subset}_tags.csv").write_text("".join(tag_lines))
    return str(root)


def _both(fn):
    """fn(module) for each package; the port's result must equal the JAX
    package's (arrays bit for bit)."""
    got, want = fn(TA), fn(JA)
    _equal(got, want)
    return got


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b, (a, b)


def test_audiocaps_loads_and_groups_captions(audiocaps_root):
    def run(m):
        train = m.AudioCaps(root=audiocaps_root, subset="train", with_tags=True)
        val = m.AudioCaps(root=audiocaps_root, subset="val", with_tags=True)
        return (len(train), len(val), val.at(0, "captions"), train.at(0, "tags"), train[0],
                [train[i]["audio"] for i in range(4)], repr(val), val.info)

    n_train, n_val, caps, tags, item, audios, _, _ = _both(run)
    assert n_train == n_val == 4 and len(caps) == 5 and tags == [0, 1]
    assert item["audio"].ndim == 1 and len(item["audio"]) == 16000 and item["tags"] == [0, 1]
    assert [len(a) for a in audios] == [16000, 17000, 18000, 19000]


def test_audiocaps_exclude_removed_audio_off_keeps_missing(audiocaps_root):
    def run(m):
        ds = m.AudioCaps(root=audiocaps_root, subset="train", with_tags=True,
                         exclude_removed_audio=False)
        with pytest.raises(FileNotFoundError):
            ds.at(4, "audio")
        return len(ds), ds.at(4, "youtube_id"), ds.at(4, "is_on_disk"), ds.at(4, "tags")

    assert _both(run)[:3] == (5, "ytmissing00", False)


def test_audiocaps_columnar_access(audiocaps_root):
    def run(m):
        ds = m.AudioCaps(root=audiocaps_root, subset="train", with_tags=True)
        return (ds.at(1, "youtube_id"), ds.column_names, ds.shape, ds.index_to_tagname,
                ds.at(slice(0, 2), "fname"), ds.at(slice(1, 3), "audio"),
                ds.at(2), ds.is_loaded())

    yt, cols, shape, names, fnames, _, item, loaded = _both(run)
    assert yt == "yttrain0001" and "captions" in cols and "audio" in cols
    assert shape[0] == 4 and len(names) == 527 and loaded
    assert fnames == ["yttrain0000_10.flac", "yttrain0001_10.flac"]
    assert "is_on_disk" not in item and item["audio"].shape == (18000,)


def test_audiocaps_flat_captions(audiocaps_root):
    def run(m):
        ds = m.AudioCaps(root=audiocaps_root, subset="val", with_tags=True, flat_captions=True)
        return len(ds), ds.at(0, "captions"), ds.at(7, "youtube_id")

    n, caps, _ = _both(run)
    assert n == 20 and len(caps) == 1


def test_audiocaps_transform_and_bad_subset(audiocaps_root):
    def run(m):
        ds = m.AudioCaps(root=audiocaps_root, subset="val", with_tags=False,
                         transform=lambda item: {"n": len(item["audio"]), **item})
        with pytest.raises(ValueError):
            m.AudioCaps(root=audiocaps_root, subset="eval")
        with pytest.raises(FileNotFoundError):
            m.AudioCaps(root=audiocaps_root, subset="test")
        return ds[3]

    item = _both(run)
    assert item["n"] == 19000 and "tags" not in item


def test_audiocaps_download_raises(audiocaps_root):
    for m in PACKAGES.values():
        with pytest.raises(RuntimeError):
            m.AudioCaps(root=audiocaps_root, subset="train", download=True)


def test_basic_collate_pads_and_onehots(audiocaps_root):
    def run(m):
        ds = m.AudioCaps(root=audiocaps_root, subset="train", with_tags=True)
        batch = m.BasicCollate(with_tags=True)([ds[i] for i in range(4)])
        filled = m.BasicCollate(audio_fill_value=0.5)([ds[i] for i in (3, 0)])
        with pytest.raises(ValueError):
            m.BasicCollate()([])
        return batch, filled, m.tag_2_onehot([3, 5]), m.tag_2_onehot([1], num_classes=4)

    batch, filled, oh, small = _both(run)
    assert batch["audio"].shape == (4, 19000) and batch["audio"].dtype == np.float32
    assert batch["tags"].shape == (4, 527)
    np.testing.assert_array_equal(batch["tags"][:, 0], 1.0)
    assert filled["audio"][1, 16000:].tolist() == [0.5] * 3000 and "tags" not in filled
    assert oh.shape == (1, 527) and oh[0, 3] == 1 and oh.sum() == 2
    assert small.tolist() == [[0.0, 1.0, 0.0, 0.0]]


def test_youtube_and_ffmpeg_commands():
    """The same argument lists as the JAX package's (reference
    audiocaps.py:688-732), defaults and every option."""
    def run(m):
        return (m.youtube_url_command("abc123"),
                m.youtube_url_command("x", youtube_dl_path="/usr/local/bin/youtube-dl"),
                m.ffmpeg_extract_command("http://a/stream", "/out/yt_10.flac", 10),
                m.ffmpeg_extract_command("u", "o.wav", 3, duration=5.0, sr=16000, n_channels=2,
                                         target_format="wav", acodec="pcm_s16le",
                                         ffmpeg_path="/usr/bin/ffmpeg"),
                m.AUDIOCAPS_LINKS, m.AUDIOSET_LINKS)

    ydl, _, cmd, _, _, _ = _both(run)
    assert ydl == ["youtube-dl", "--youtube-skip-dash-manifest", "-g",
                   "https://www.youtube.com/watch?v=abc123"]
    assert cmd == ["ffmpeg", "-i", "http://a/stream", "-vn", "-f", "flac", "-acodec", "flac",
                   "-ss", "10", "-t", "10.00096876", "-ar", "32000", "-ac", "1",
                   "/out/yt_10.flac"]


def _prepare(m, root, results):
    """tests/test_audiocaps.py's prepare flow on its own root: download,
    skip when cached, repair zero-byte leftovers, missing CSV raises."""
    prep_root = root / "prep_root"
    data = prep_root / "AUDIOCAPS_32000Hz"
    data.mkdir(parents=True)
    lines = ["audiocap_id,youtube_id,start_time,caption\n"] + [
        f"{i},yttrain{i:04d},10,a caption\n" for i in range(4)]
    (data / "train.csv").write_text("".join(lines))
    commands = {"url": [], "extract": []}

    def fake_output(cmd):
        commands["url"].append(cmd[:-1] + [cmd[-1].replace(str(root), "ROOT")])
        return b"http://video\nhttp://audio\n"

    def fake_call(cmd):
        commands["extract"].append([c.replace(str(root), "ROOT") for c in cmd])
        open(cmd[-1], "wb").close()
        return 0

    counts = [m.prepare_audiocaps_subset(str(prep_root), "train", run_output=fake_output,
                                         run_call=fake_call),
              m.prepare_audiocaps_subset(str(prep_root), "train", run_output=fake_output,
                                         run_call=fake_call, validate_cache=lambda p: True),
              m.prepare_audiocaps_subset(str(prep_root), "train", run_output=fake_output,
                                         run_call=fake_call)]
    with pytest.raises(FileNotFoundError, match="cdjkim/audiocaps"):
        m.prepare_audiocaps_subset(str(root), "test")
    with pytest.raises(ValueError):
        m.prepare_audiocaps_subset(str(prep_root), "eval")
    # a failing resolver and a failing download count as errors
    (data / "audio" / "train" / "yttrain0000_10.flac").unlink()
    err = m.prepare_audiocaps_subset(
        str(prep_root), "train", run_output=lambda c: b"only one line",
        run_call=fake_call, validate_cache=lambda p: True)
    results[m.__name__] = (counts, commands, err)


def test_prepare_audiocaps_subset_with_mock_runners(tmp_path):
    results = {}
    for name, m in PACKAGES.items():
        (tmp_path / name).mkdir()
        _prepare(m, tmp_path / name, results)
    (counts, commands, err), want = results[TA.__name__], results[JA.__name__]
    _equal((counts, commands, err), want)
    assert counts[0] == {"ok": 4, "err": 0, "skipped": 0}
    assert counts[1] == {"ok": 0, "err": 0, "skipped": 4}
    assert counts[2]["ok"] == 4 and counts[2]["skipped"] == 0
    assert err == {"ok": 0, "err": 1, "skipped": 3}
    assert commands["url"][0][-1].endswith("watch?v=yttrain0000")
    assert commands["extract"][0][2] == "http://audio"


def test_download_and_extract_runner_failures(tmp_path):
    def boom(cmd):
        raise OSError("no network")

    def run(m):
        return (m.download_and_extract_from_youtube("id", str(tmp_path / "o.flac"), 5,
                                                    run_output=boom, run_call=boom),
                m.download_and_extract_from_youtube("id", str(tmp_path / "o.flac"), 5,
                                                    run_output=lambda c: b"v\na\n",
                                                    run_call=boom),
                m.download_and_extract_from_youtube("id", str(tmp_path / "o.flac"), 5,
                                                    run_output=lambda c: b"v\na\n",
                                                    run_call=lambda c: 1))

    assert _both(run) == (False, False, False)


def test_cache_probe_without_soundfile(tmp_path):
    """Neither machine has soundfile: the probe reads the container magic and
    wants more than 1 KiB."""
    cases = {"ok.flac": b"fLaC" + b"\0" * 2000, "small.flac": b"fLaC" + b"\0" * 10,
             "riff.wav": b"RIFF" + b"\0" * 2000, "junk.flac": b"JUNK" + b"\0" * 2000}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
    got = {n: TA._audio_file_valid(str(tmp_path / n)) for n in [*cases, "missing.flac"]}
    want = {n: JA._audio_file_valid(str(tmp_path / n)) for n in [*cases, "missing.flac"]}
    assert got == want == {"ok.flac": True, "small.flac": False, "riff.wav": True,
                           "junk.flac": False, "missing.flac": False}
