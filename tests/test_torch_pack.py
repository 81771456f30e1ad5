"""The port's dataset packing (``data/pack.py``, ``cli/pack_dataset.py``)
against the JAX package's, on WAV and FLAC clips (``tests/flac_encoder.py``).

Packed HDF5 files, index files, the combined index, the split CSVs, the
``download_wavs`` dry-run commands and every ``pack_dataset`` subcommand's
output are identical to the JAX package's. At 32 kHz the packed int16
waveforms are bit-equal (no resampling). At 44.1 and 48 kHz both packages
resample with the same C++ loop, built with other flags (the JAX Makefile
adds ``-march=native``, the port does not), and ``float32_to_int16``
truncates, so a 1e-7 difference can move a sample by one step: the test
holds them to 1 LSB and prints the share of samples that moved.
"""

import h5py
import numpy as np
import pytest
from scipy.io import wavfile

from audioset_convnext_inf_tpu.cli import pack_dataset as JCLI
from audioset_convnext_inf_tpu.data import pack as JP

from audioset_convnext_inf_torch.cli import pack_dataset as CLI
from audioset_convnext_inf_torch.data import pack as P

from tests.flac_encoder import encode_flac

CLIP = 16000  # half a second at 32 kHz
LABELS = ['"/m/09x0r"', '"/m/09x0r,/m/05zppz"', '"/m/05zppz"']


def _row(ytid, start, end, label):
    return f"{ytid}, {start:.3f}, {end:.3f}, {label}\n"


def _csv(path, rows):
    path.write_text("# Segments csv\n# num_ytids=x\n# YTID, start_seconds, end_seconds, "
                    "positive_labels\n" + "".join(rows))
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Clips of ~0.3-0.7 s: 32-kHz WAV and FLAC, and WAV at 44.1 and 48 kHz
    (and a FLAC at 44.1 kHz); one CSV per kind, each with a row whose file
    is missing."""
    root = tmp_path_factory.mktemp("pack")
    audio = root / "audio"
    audio.mkdir()
    rng = np.random.RandomState(0)
    csvs = {}
    for kind, sr, ext in (("wav32", 32000, ".wav"), ("flac32", 32000, ".flac"),
                          ("wav44", 44100, ".wav"), ("wav48", 48000, ".wav"),
                          ("flac44", 44100, ".flac")):
        rows = []
        for i in range(3):
            ytid = f"{kind:_<6}{i:05d}"  # 11 characters, as YouTube ids
            start = 0.0 if i == 0 else 30.0 + i
            name = P._clip_name([ytid, f"{start:.3f}", f"{start + 10:.3f}"]) + ext
            pcm = (rng.randn(int(sr * (0.3 + 0.2 * i))) * 3000).astype(np.int16)
            if ext == ".wav":
                wavfile.write(str(audio / name), sr, pcm)
            else:
                (audio / name).write_bytes(encode_flac(pcm.astype(np.int64), sr))
            rows.append(_row(ytid, start, start + 10, LABELS[i]))
        rows.append(_row(f"{kind:_<6}99999", 0.0, 10.0, LABELS[0]))  # no such file
        csvs[kind] = (_csv(root / f"{kind}.csv", rows), ext)
    return root, str(audio), csvs


def _read_h5(path):
    with h5py.File(path, "r") as hf:
        return {k: hf[k][:] for k in hf}, dict(hf.attrs)


def _pack_both(corpus, kind, tmp_path, **kw):
    _, audio, csvs = corpus
    csv, ext = csvs[kind]
    got = P.pack_waveforms_to_hdf5(csv, audio, str(tmp_path / "port.h5"), clip_samples=CLIP,
                                   audio_ext=ext, **kw)
    want = JP.pack_waveforms_to_hdf5(csv, audio, str(tmp_path / "jax.h5"), clip_samples=CLIP,
                                     audio_ext=ext, **kw)
    return _read_h5(got), _read_h5(want)


@pytest.mark.parametrize("kind", ["wav32", "flac32"])
def test_pack_at_32k_is_bit_equal(corpus, kind, tmp_path):
    (got, gattrs), (want, wattrs) = _pack_both(corpus, kind, tmp_path)
    assert sorted(got) == sorted(want) == ["audio_name", "target", "waveform"]
    assert gattrs == wattrs and int(gattrs["sample_rate"]) == 32000
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["waveform"].shape == (3, CLIP) and got["audio_name"][0] == f"{kind:_<6}00000".encode()
    assert not got["waveform"][0, 9600:].any() and got["waveform"][2, -1] != 0  # padded, cut
    (mini, _), (jmini, _) = _pack_both(corpus, kind, tmp_path, mini_data=2)
    assert mini["waveform"].shape == (2, CLIP)
    np.testing.assert_array_equal(mini["waveform"], jmini["waveform"])


@pytest.mark.parametrize("kind", ["wav44", "wav48", "flac44"])
def test_pack_resampled_within_one_step(corpus, kind, tmp_path):
    (got, gattrs), (want, wattrs) = _pack_both(corpus, kind, tmp_path)
    assert gattrs == wattrs
    np.testing.assert_array_equal(got["audio_name"], want["audio_name"])
    np.testing.assert_array_equal(got["target"], want["target"])
    diff = np.abs(got["waveform"].astype(np.int32) - want["waveform"].astype(np.int32))
    assert diff.max() <= 1
    print(f"{kind}: {int((diff > 0).sum())} of {diff.size} samples one step apart "
          f"({(diff > 0).mean():.2e})")


def test_metadata_split_and_indexes_match(corpus, tmp_path):
    root, audio, csvs = corpus
    for kind, (csv, ext) in csvs.items():
        got, want = P.read_metadata(csv, audio, audio_ext=ext), JP.read_metadata(csv, audio,
                                                                                 audio_ext=ext)
        np.testing.assert_array_equal(got["audio_name"], want["audio_name"])
        np.testing.assert_array_equal(got["target"], want["target"])
        assert len(got["audio_name"]) == 3
    got = P.split_unbalanced_csv_to_partial_csvs(csvs["wav32"][0], str(tmp_path / "p"), 3)
    want = JP.split_unbalanced_csv_to_partial_csvs(csvs["wav32"][0], str(tmp_path / "j"), 3)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == [
        "unbalanced_train_segments_part00.csv", "unbalanced_train_segments_part01.csv"]
    for g, w in zip(got, want):
        assert open(g).read() == open(w).read()
    packed = []
    for kind in ("wav32", "flac32"):
        csv, ext = csvs[kind]
        packed.append(JP.pack_waveforms_to_hdf5(csv, audio, str(tmp_path / f"{kind}.h5"),
                                                clip_samples=CLIP, audio_ext=ext))
    idx = []
    for i, path in enumerate(packed):
        g = P.create_indexes(path, str(tmp_path / f"port_idx{i}.h5"))
        w = JP.create_indexes(path, str(tmp_path / f"jax_idx{i}.h5"))
        (gd, ga), (wd, wa) = _read_h5(g), _read_h5(w)
        assert ga == wa and sorted(gd) == sorted(wd)
        for k in wd:
            assert gd[k].dtype == wd[k].dtype, k
            np.testing.assert_array_equal(gd[k], wd[k], err_msg=k)
        idx.append(g)
    g = _read_h5(P.combine_indexes(idx, str(tmp_path / "port_all.h5")))[0]
    w = _read_h5(JP.combine_indexes(idx, str(tmp_path / "jax_all.h5")))[0]
    assert g["index_in_hdf5"].tolist() == [0, 1, 2, 0, 1, 2]
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("mini_data", [0, 2])
def test_download_commands_match(corpus, tmp_path, mini_data):
    """The dry run builds the JAX package's command triples and runs none:
    no audio appears."""
    csv = corpus[2]["wav44"][0]
    got = P.download_wavs(csv, str(tmp_path / "p"), mini_data=mini_data, dry_run=True)
    want = JP.download_wavs(csv, str(tmp_path / "p"), mini_data=mini_data, dry_run=True)
    assert got == want and len(got) == 3 * (mini_data or 4)
    assert got[1].startswith("ffmpeg -y -i ") and "-ac 1 -ar 32000 -ss 31.0 -t 10.0" in got[4]
    assert not list((tmp_path / "p").iterdir())
    got = P.download_wavs(csv, str(tmp_path / "q"), downloader="no-such-tool-here")
    assert got == JP.download_wavs(csv, str(tmp_path / "q"), downloader="no-such-tool-here")
    assert not list((tmp_path / "q").iterdir())


def test_every_subcommand_matches_jax(corpus, tmp_path, capsys):
    root, audio, csvs = corpus
    csv, _ = csvs["wav32"]

    def both(argv_of):
        outs = []
        for tag, main in (("port", CLI.main), ("jax", JCLI.main)):
            assert main(argv_of(tag)) == 0
            outs.append(capsys.readouterr().out.strip())
        return outs

    got, want = both(lambda t: ["pack", "--csv", csv, "--audios-dir", audio, "--out",
                                str(tmp_path / f"{t}.h5"), "--mini-data", "2"])
    assert got.endswith("port.h5") and want.endswith("jax.h5")
    (g, ga), (w, wa) = _read_h5(got), _read_h5(want)
    assert ga == wa and all(np.array_equal(g[k], w[k]) for k in w)
    assert g["waveform"].shape == (2, 320000)
    got, want = both(lambda t: ["index", "--waveforms", str(tmp_path / "jax.h5"), "--out",
                                str(tmp_path / f"{t}_idx.h5")])
    (g, _), (w, _) = _read_h5(got), _read_h5(want)
    assert all(np.array_equal(g[k], w[k]) for k in w) and sorted(g) == sorted(w)
    got, want = both(lambda t: ["combine", "--indexes", str(tmp_path / "jax_idx.h5"),
                                str(tmp_path / "port_idx.h5"), "--out",
                                str(tmp_path / f"{t}_all.h5")])
    (g, _), (w, _) = _read_h5(got), _read_h5(want)
    assert all(np.array_equal(g[k], w[k]) for k in w) and len(g["audio_name"]) == 4
    got, want = both(lambda t: ["split", "--csv", csv, "--out-dir", str(tmp_path / f"{t}_parts")])
    assert got.replace("port_parts", "jax_parts") == want
    dcase = tmp_path / "testing_set.csv"
    dcase.write_text("Y0000003xxx_60.000_70.000.wav\t2.3\t4.5\tTrain horn\n"
                     "Y0000007xxx_10.000_20.000.wav,0.0,3.1,Air horn\n"
                     "Y0000003xxx_60.000_70.000.wav\t5.0\t6.0\tTrain horn\n")
    got, want = both(lambda t: ["blacklist", "--csvs", str(dcase), "--out",
                                str(tmp_path / f"{t}_black.csv")])
    assert open(got).read() == open(want).read() == "Y0000003xxx\nY0000007xxx\n"
