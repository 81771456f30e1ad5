"""The port's training CLI and its data plane against the JAX package's.

Samplers (the same batch metas from the same seed and index), the
blacklist tools, the statistics history, the metric log and the label
tables are held against the JAX package's. ``cli/train.py`` runs on the CPU
(convnext_atto, half-second clips from ``tests/make_synth_hdf5.py``): a
checkpoint reloads, 4 steps straight equal 2 + resume + 2 bit for bit, the
JAX package reads what the port writes, and a JAX-written checkpoint with
an optax state resumes in the port. The optax state of every structure the
JAX trainer builds converts to the port's optimizer state, whose next
update equals optax's.
"""

import json
import os
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu import labels as JLB
from audioset_convnext_inf_tpu.checkpoint import io as JIO
from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.data import blacklist as JBL
from audioset_convnext_inf_tpu.data import samplers as JS
from audioset_convnext_inf_tpu.engine import statistics as JST
from audioset_convnext_inf_tpu.engine import trainer as JT
from audioset_convnext_inf_tpu.models import api as jax_api
from audioset_convnext_inf_tpu.utils import logging_utils as JLU

from audioset_convnext_inf_torch import labels as LB
from audioset_convnext_inf_torch.checkpoint import io as IO
from audioset_convnext_inf_torch.checkpoint import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from audioset_convnext_inf_torch.cli import train as train_cli
from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.data import blacklist as BL
from audioset_convnext_inf_torch.data import load_index
from audioset_convnext_inf_torch.data import samplers as PS
from audioset_convnext_inf_torch.engine import statistics as ST
from audioset_convnext_inf_torch.engine import trainer as T
from audioset_convnext_inf_torch.models import ConvNeXt
from audioset_convnext_inf_torch.utils import logging_utils as LU

from tests.make_synth_hdf5 import make_packed_and_index
from tests.test_torch_checkpoint import _port_init

SAMPLERS = ("TrainSampler", "BalancedTrainSampler", "AlternateTrainSampler")
MODEL = "convnext_atto"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A synthetic index of 16 half-second clips and a blacklist of 3 of
    their YouTube ids (the first 11 characters of the audio names)."""
    d = tmp_path_factory.mktemp("h5")
    _, index = make_packed_and_index(str(d), n_clips=16, clip_samples=16000)
    black = BL.write_black_list([f"Y{i:07d}xxx" for i in (1, 6, 11)], str(d / "black.csv"))
    return index, black


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def _take(sampler, n):
    it = iter(sampler)
    return [next(it) for _ in range(n)]


def _same_metas(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [(m["hdf5_path"], m["index_in_hdf5"]) for m in a] == \
               [(m["hdf5_path"], m["index_in_hdf5"]) for m in b]


@pytest.mark.parametrize("blacklisted", [False, True])
@pytest.mark.parametrize("name", SAMPLERS)
def test_samplers_give_the_jax_batches(synth, name, blacklisted):
    """The first 20 batches of 6 metas (several epochs and per-class wraps)
    are the JAX sampler's, from the HDF5 path and from the index in memory."""
    index, black = synth
    csv = black if blacklisted else None
    want = _take(getattr(JS, name)(index, 6, csv, 7), 20)
    _same_metas(_take(getattr(PS, name)(index, 6, csv, 7), 20), want)
    _same_metas(_take(getattr(PS, name).from_index(load_index(index), 6, csv, 7), 20), want)
    if blacklisted:
        seen = {m["index_in_hdf5"] for batch in want for m in batch}
        assert not seen & {1, 6, 11} and len(seen) == 13


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_state_round_trip_gives_the_same_next_batches(synth, name):
    """state_dict after 7 batches, then load_state_dict into a sampler of
    another seed: the next 10 batches are the uninterrupted sampler's, and
    the state is the JAX sampler's at the same point."""
    index, black = synth
    a = getattr(PS, name)(index, 5, black, 3)
    ja = getattr(JS, name)(index, 5, black, 3)
    it, jit = iter(a), iter(ja)
    for _ in range(7):
        next(it)
        next(jit)
    state = a.state_dict()
    want = [next(it) for _ in range(10)]
    leaves = jax.tree_util.tree_leaves(state)
    jleaves = jax.tree_util.tree_leaves(ja.state_dict())
    assert len(leaves) == len(jleaves)
    for x, y in zip(leaves, jleaves):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    b = getattr(PS, name)(index, 5, black, 99)
    b.load_state_dict(pickle.loads(pickle.dumps(state)))
    _same_metas(_take(b, 10), want)


def test_evaluate_sampler_from_index_matches_the_path(synth):
    index, _ = synth
    got = list(PS.EvaluateSampler.from_index(load_index(index), 5))
    want = list(JS.EvaluateSampler(index, 5))
    assert [len(b) for b in got] == [5, 5, 5, 1]
    for a, b in zip(got, want):
        for m, n in zip(a, b):
            assert (m["audio_name"], m["hdf5_path"], m["index_in_hdf5"]) == \
                   (n["audio_name"], n["hdf5_path"], n["index_in_hdf5"])
            np.testing.assert_array_equal(m["target"], n["target"])


# ---------------------------------------------------------------------------
# Blacklist, statistics, logging, labels
# ---------------------------------------------------------------------------

def test_blacklist_tools_match_jax(tmp_path):
    a = tmp_path / "testing.csv"
    a.write_text("-5QrBL6MzLg_60.000_70.000.wav\t60.000\t70.000\tTrain\n\n"
                 "-5QrBL6MzLg_80.000_90.000.wav\t80\t90\tTrain\n")
    b = tmp_path / "eval.csv"
    b.write_text("abcdefghijk_0.000_10.000.wav,0,10,Car\n-5QrBL6MzLg_1.0_2.0.wav,1,2,x\n")
    ids = BL.dcase2017_task4_ids([str(a), str(b)])
    assert ids == JBL.dcase2017_task4_ids([str(a), str(b)]) == ["-5QrBL6MzLg", "abcdefghijk"]
    ours = BL.write_black_list(ids, str(tmp_path / "out" / "black.csv"))
    theirs = JBL.write_black_list(ids, str(tmp_path / "jax" / "black.csv"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert PS.read_black_list(ours) == JS.read_black_list(theirs) == ids


def test_statistics_pickle_and_resume_match_jax(tmp_path):
    """The same appends pickle the same dict (and its backup); resuming at
    iteration 20 keeps the same evaluations in both."""
    path = str(tmp_path / "stats" / "statistics.pkl")
    for cls in (ST.StatisticsContainer, JST.StatisticsContainer):
        sc = cls(path)
        for it in (10, 20, 30):
            sc.append(it, {"mAP": it / 100, "mAUC": 0.5, "dprime": 0.1}, "test")
            sc.append(it, {"mAP": it / 200}, "bal")
        sc.dump()
        with open(path, "rb") as f:
            dumped = pickle.load(f)
        with open(sc.backup_statistics_path, "rb") as f:
            assert pickle.load(f) == dumped
        if cls is ST.StatisticsContainer:
            ours = dumped
    assert ours == dumped
    port, ref = ST.StatisticsContainer(path), JST.StatisticsContainer(path)
    port.load_state_dict(20)
    ref.load_state_dict(20)
    assert port.statistics_dict == ref.statistics_dict
    assert [s["iteration"] for s in port.statistics_dict["test"]] == [10, 20]


def test_metric_log_matches_jax(tmp_path, monkeypatch):
    """With WANDB_MODE=disabled both write the same JSON lines (but the
    time stamps)."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    records = {}
    for tag, cls in (("port", LU.MetricLogger), ("jax", JLU.MetricLogger)):
        out = tmp_path / tag
        logger = cls(run_name="r", out_dir=str(out), config={"lr": 1e-3, "model": "atto"})
        logger.log({"test/mAP": 0.25}, step=5)
        logger.log({"bal/mAP": 0.5, "bal/dprime": 1.0})
        logger.finish()
        lines = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
        records[tag] = [{k: v for k, v in r.items() if k != "_ts"} for r in lines]
    assert records["port"] == records["jax"]
    assert records["port"][1] == {"test/mAP": 0.25, "_step": 5}
    root = LU.create_logging(str(tmp_path / "logs"))
    console = root.handlers[-1]
    root.removeHandler(console)  # the console echo it added
    assert os.path.isdir(tmp_path / "logs") and console.level == 20


def test_label_tables_match_jax(tmp_path):
    np.testing.assert_array_equal(LB.full_samples_per_class(), JLB.full_samples_per_class())
    assert LB.full_samples_per_class().shape == (527,)
    maps = LB.read_audioset_label_tags()
    onto = tmp_path / "ontology.json"
    onto.write_text(json.dumps([
        {"id": maps.ix_to_id[3], "description": "third"},
        {"id": "/m/not_a_label", "description": "skip"},
        {"id": maps.ix_to_id[0], "description": "first"},
    ]))
    assert LB.read_audioset_ontology(str(onto)) == JLB.read_audioset_ontology(str(onto)) == \
        ["third", "first"]


# ---------------------------------------------------------------------------
# The optax state of the JAX trainer -> the port's optimizer state
# ---------------------------------------------------------------------------

TINY = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), drop_path_rate=0.0)
STRUCTURES = {
    "optax.adamw": dict(),
    "optax.adam": dict(optimizer="adam"),
    "optax.inject_hyperparams(adamw)": dict(use_wd_schedule=True, wd_constant_cooldown=False),
    "optax.MultiSteps(optax.adamw)": dict(accumulation_steps=2),
    "optax.MultiSteps(optax.inject_hyperparams(adamw))": dict(accumulation_steps=2,
                                                              use_wd_schedule=True),
}


def _grads(params, rng):
    """Random gradients in the JAX layout; bn0's running statistics get
    none, as in training (the loss never reaches them)."""
    g = jax.tree_util.tree_map(lambda p: rng.randn(*np.shape(p)).astype(np.float32), params)
    g["bn0"]["mean"] = np.zeros_like(g["bn0"]["mean"])
    g["bn0"]["var"] = np.zeros_like(g["bn0"]["var"])
    return g


def _port_tree(tree):
    sd = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()
            if k not in ("bn0.running_mean", "bn0.running_var")}


def _adam_state(state):
    """ScaleByAdamState inside any of the JAX trainer's structures."""
    state = getattr(state, "inner_opt_state", state)
    state = getattr(state, "inner_state", state)
    return state[0]


@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_optax_state_converts_and_the_next_update_matches(tmp_path, structure):
    """Three optax updates, the state saved by the JAX package's
    save_checkpoint and read by the port: count, mini_step, mu, nu and the
    accumulated gradients equal optax's; then one more update with the same
    gradients gives the same parameters within 1e-6."""
    kw = dict(max_lr=1e-2, total_steps=10, weight_decay=0.1, **STRUCTURES[structure])
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(jnp.asarray, _port_init(ConvNeXtConfig(**TINY), 1))
    tx = JT.make_optimizer(params, JT.TrainConfig(**kw))
    state, update = tx.init(params), jax.jit(tx.update)
    for _ in range(3):
        updates, state = update(_grads(params, rng), state, params)
        params = optax.apply_updates(params, updates)
    JIO.save_checkpoint(str(tmp_path), params, JaxConfig(**TINY), opt_state=state, iteration=3)

    got = IO.optimizer_state_from_optax(IO.load_checkpoint(str(tmp_path))["opt_state"])
    adam = _adam_state(state)
    assert got["structure"] == structure == T.optax_structure(T.TrainConfig(**kw))
    assert got["count"] == int(adam.count) == (1 if kw.get("accumulation_steps") else 3)
    assert got["mini_step"] == int(getattr(state, "mini_step", 0))
    for key, tree in (("mu", adam.mu), ("nu", adam.nu),
                      ("acc", getattr(state, "acc_grads", None))):
        if tree is None:
            assert got[key] is None
            continue
        want = _port_tree(tree)
        assert sorted(got[key]) == sorted(want) and len(want) == 58
        for k in want:
            np.testing.assert_array_equal(got[key][k], want[k].numpy(), err_msg=f"{key} {k}")

    ours = _port_tree(params)
    opt = T.Optimizer(ours, T.TrainConfig(**kw))
    opt.load_state_dict(got)
    g = _grads(params, rng)
    updates, state = update(g, state, params)
    params = optax.apply_updates(params, updates)
    opt.step(_port_tree(g))
    for k, want in _port_tree(params).items():
        np.testing.assert_allclose(ours[k].numpy(), want.numpy(), atol=1e-6, rtol=0, err_msg=k)


def test_other_optimizer_states_are_refused(tmp_path):
    params = jax.tree_util.tree_map(jnp.asarray, _port_init(ConvNeXtConfig(**TINY), 1))
    state = optax.sgd(0.1, momentum=0.9).init(params)
    JIO.save_checkpoint(str(tmp_path), params, JaxConfig(**TINY), opt_state=state)
    with pytest.raises(ValueError, match="TraceState"):
        IO.optimizer_state_from_optax(IO.load_checkpoint(str(tmp_path))["opt_state"])
    adam = JT.make_optimizer(params, JT.TrainConfig()).init(params)  # optax.adamw
    model = ConvNeXt(ConvNeXtConfig(**TINY), device="cpu")
    tr = T.Trainer(model, T.TrainConfig(optimizer="adam"))
    with pytest.raises(ValueError, match="optax.adamw state; this training config builds "
                                         "optax.adam"):
        tr.restore(model.state_dict(), jax.tree_util.tree_map(np.asarray, adam), 0)


# ---------------------------------------------------------------------------
# cli/train.py
# ---------------------------------------------------------------------------

def _argv(index, workspace, early_stop, resume=0, **extra):
    argv = ["--train-indexes", index, "--model", MODEL, "--batch-size", "4",
            "--sampler", "balanced", "--mixup-alpha", "1.0", "--early-stop", str(early_stop),
            "--eval-interval", "0", "--checkpoint-interval", "2", "--num-workers", "2",
            "--workspace", workspace, "--total-steps", "100", "--seed", "5", "--device", "cpu"]
    if resume:
        argv += ["--resume-iteration", str(resume)]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def _ckpt(workspace, it):
    return os.path.join(workspace, "checkpoints", MODEL, f"{it}_iterations")


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """4 steps straight (an evaluation every 2, the metric log in JSONL),
    and 2 steps in another workspace."""
    index, _ = synth
    ws = tmp_path_factory.mktemp("ws")
    straight, two = str(ws / "straight"), str(ws / "two")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WANDB_MODE", "disabled")
        assert train_cli.main(_argv(index, straight, 4, eval_interval=2, eval_indexes=index,
                                    eval_batch_size=8)) == 0
        assert train_cli.main(_argv(index, two, 2)) == 0
        yield index, straight, two


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_two_steps_write_a_checkpoint_that_reloads(runs):
    _, straight, two = runs
    state = IO.load_checkpoint(_ckpt(two, 2))
    assert state["iteration"] == 2 and state["sampler_state"] is not None
    opt = IO.optimizer_state_from_optax(state["opt_state"])  # written in optax's layout
    assert opt["count"] == 2 and opt["acc"] is None and opt["structure"] == "optax.adamw"
    assert state["config"].name == MODEL
    ref = IO.load_checkpoint(_ckpt(straight, 2))  # the straight run's checkpoint at 2
    for x, y in zip(_flat(state["params"]), _flat(ref["params"])):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(_flat(state["sampler_state"]), _flat(ref["sampler_state"])):
        np.testing.assert_array_equal(x, y)
    stats = pickle.load(open(os.path.join(straight, "statistics", MODEL, "statistics.pkl"), "rb"))
    assert [s["iteration"] for s in stats["test"]] == [2] and stats["bal"] == []
    assert np.isfinite(stats["test"][0]["mAP"])
    lines = open(os.path.join(straight, "metrics", MODEL, "metrics.jsonl")).read().splitlines()
    assert json.loads(lines[-1])["_step"] == 2 and "test/mAP" in json.loads(lines[-1])


def test_resume_is_bit_identical_to_the_straight_run(runs):
    """2 steps, then a fresh process state resuming at 2 for 2 more: the
    parameters, optimizer and sampler state equal the 4-step run's bit for
    bit (sampler, optimizer and per-step draws all restored)."""
    index, straight, two = runs
    assert train_cli.main(_argv(index, two, 4, resume=2)) == 0
    a, b = IO.load_checkpoint(_ckpt(straight, 4)), IO.load_checkpoint(_ckpt(two, 4))
    assert a["iteration"] == b["iteration"] == 4
    for part in ("params", "opt_state", "sampler_state"):
        xa, xb = (_flat(IO.optimizer_state_from_optax(x[part]) if part == "opt_state" else x[part])
                  for x in (a, b))
        assert len(xa) == len(xb) > 4
        for x, y in zip(xa, xb):
            np.testing.assert_array_equal(x, y, err_msg=part)


def test_jax_reads_a_port_training_checkpoint(runs, sample_wav_path):
    """The JAX package's load_checkpoint reads the port's checkpoint
    (optimizer and sampler state included), and its ConvNeXt gives the
    port's forward from it within 2e-4."""
    _, straight, _ = runs
    path = _ckpt(straight, 4)
    state = JIO.load_checkpoint(path)
    assert state["iteration"] == 4 and int(state["opt_state"][0].count) == 4
    assert isinstance(state["opt_state"][0], optax.ScaleByAdamState)
    assert state["config"].name == MODEL
    from scipy.io import wavfile

    _, data = wavfile.read(sample_wav_path)
    wav = (data[:16000].astype(np.float32) / 32767.0)[None]
    jm = jax_api.ConvNeXt(state["config"], state["params"])
    pm = ConvNeXt.from_pretrained(path, cfg=IO.load_checkpoint(path)["config"], device="cpu")
    np.testing.assert_allclose(pm.forward(wav)["clipwise_logits"].numpy(),
                               np.asarray(jm.forward(wav)["clipwise_logits"]), atol=2e-4, rtol=0)


def test_a_jax_checkpoint_with_optax_state_resumes_in_the_port(runs, tmp_path):
    """The port's checkpoint at 2, written again by the JAX package with the
    optimizer state as optax.adamw's: resuming from it for 2 steps gives the
    4-step run's parameters bit for bit."""
    index, straight, _ = runs
    port = IO.load_checkpoint(_ckpt(straight, 2))
    params = jax.tree_util.tree_map(jnp.asarray, port["params"])
    opt = IO.optimizer_state_from_optax(port["opt_state"])

    def tree(moments):
        zeros = np.zeros_like(port["params"]["bn0"]["mean"])
        return jax_params_from_state_dict(
            dict(moments, **{"bn0.running_mean": zeros, "bn0.running_var": zeros}))

    chain = JT.make_optimizer(params, JT.TrainConfig()).init(params)  # optax.adamw
    count = jnp.asarray(opt["count"], jnp.int32)
    state = (chain[0]._replace(count=count, mu=tree(opt["mu"]), nu=tree(opt["nu"])),
             chain[1], chain[2]._replace(count=count))
    ws = str(tmp_path / "ws")
    JIO.save_checkpoint(_ckpt(ws, 2), params, port["config"], opt_state=state,
                        sampler_state=port["sampler_state"], iteration=2)
    assert train_cli.main(_argv(index, ws, 4, resume=2)) == 0
    a, b = IO.load_checkpoint(_ckpt(straight, 4)), IO.load_checkpoint(_ckpt(ws, 4))
    for x, y in zip(_flat(a["params"]), _flat(b["params"])):
        np.testing.assert_array_equal(x, y)
