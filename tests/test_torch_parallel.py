"""The port's data parallelism (``parallel/``) on the CPU, gloo backend.

Spawned processes (``tests/torch_parallel_worker.py``) join a process group
through a file rendezvous under ``tmp_path`` (no port, so pytest workers
side by side cannot collide). The world-2 train step is held against the
port's one-process step on the same global batch, with the JAX package's
own constants for its sharded step (tests/test_parallel.py): loss rtol
1e-5, parameters and bn0's statistics atol 1e-5 (Adam's division by
sqrt(v) can lift reduction-order noise in the gradients to about 3e-6).
It is also held against the JAX package's Trainer on a 2-device CPU mesh.
The sharded Evaluator and ``ShardedModel`` are held against one device;
``cli/train.py`` runs at world 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.config import AugmentConfig as JaxAugmentConfig
from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.engine import trainer as JT
from audioset_convnext_inf_tpu.parallel import dist as jax_dist
from audioset_convnext_inf_tpu.parallel.mesh import get_mesh as jax_get_mesh

from audioset_convnext_inf_torch.checkpoint import jax_params_from_state_dict
from audioset_convnext_inf_torch.engine.trainer import CollectiveTimer, Trainer
from audioset_convnext_inf_torch.parallel import dist, mesh as M

from tests import torch_parallel_worker as W

BUFFERS = ("bn0.running_mean", "bn0.running_var")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of 2 ranks saw over the trainer cases."""
    return W.spawn(W.trainer_cases, 2, str(tmp_path_factory.mktemp("dp")))


def _one_process(name, grads=False):
    model = W.case_model(name)
    trainer = Trainer(model, W.case_train_config(name))
    loss = trainer.step(*W.case_batch(name))
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    if grads:
        return loss, state, {k: p.grad.numpy() for k, p in model.named_parameters()}
    return loss, state


# ---------------------------------------------------------------------------
# The bootstrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodelist", ["node[001-004,007]", "gpu-a[01-04]", "tpu-vm-3",
                                      "host1,host2", "n[5]"])
def test_slurm_head_node_parse_matches_jax(nodelist):
    assert dist._slurm_head_node(nodelist) == jax_dist._slurm_head_node(nodelist)


def test_job_resolution_order():
    """Explicit arguments, then torchrun's environment, then SLURM's, then
    a lone process."""
    torchrun = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
                "MASTER_PORT": "2222"}
    slurm = {"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
             "SLURM_STEP_NODELIST": "gpu-a[01-04]", "SLURM_JOBID": "123456"}
    assert dist.resolve_job(environ=torchrun) == {
        "init_method": "tcp://h0:2222", "world_size": 4, "rank": 3, "local_rank": 1}
    assert dist.resolve_job(environ=slurm) == {
        "init_method": f"tcp://gpu-a01:{12345 + 123456 % 10000}", "world_size": 8, "rank": 5,
        "local_rank": 1}
    assert dist.resolve_job(environ=dict(slurm, **torchrun))["world_size"] == 4
    assert dist.resolve_job("file:///x", 2, 1, environ=torchrun) == {
        "init_method": "file:///x", "world_size": 2, "rank": 1, "local_rank": 1}
    assert dist.resolve_job(environ={}) is None
    with pytest.raises(ValueError, match="outside"):
        dist.resolve_job("file:///x", 2, 2, environ={})


def test_no_card_raises_unless_the_cpu_is_asked_for(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.initialize_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.get_mesh()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("SLURM_NTASKS", raising=False)
    assert not dist.initialize_distributed()  # a lone process: nothing to join
    assert dist.rank() == 0 and dist.world_size() == 1 and dist.is_primary()
    assert M.get_mesh(["cpu"]) == M.Mesh((torch.device("cpu"),))


def test_shards_and_padding():
    mesh = M.Mesh((torch.device("cpu"),), rank=1, world_size=4)
    x = np.arange(16)
    assert M.batch_sharding(mesh, 16) == slice(4, 8)
    got = M.shard_batch({"waveform": x, "target": torch.arange(16), "name": "n"}, mesh)
    assert got["waveform"].tolist() == [4, 5, 6, 7] and got["target"].tolist() == [4, 5, 6, 7]
    assert got["name"] == "n"
    wav, target = M.shard_batch((x, x * 2), mesh)
    assert wav.tolist() == [4, 5, 6, 7] and target.tolist() == [8, 10, 12, 14]
    with pytest.raises(ValueError, match="does not split"):
        M.batch_sharding(mesh, 10)

    class Rows(torch.nn.Module):  # each replica's block, tagged by its device
        device = torch.device("cpu")

        def forward(self, x):
            return {"rows": x * 10 + x.shape[0]}

    # 5 rows over 4 devices: padded to 8, blocks of 2, the padding trimmed
    out = M.Replicas(Rows(), ["cpu"] * 4)(np.arange(5))
    assert out["rows"].tolist() == [2, 12, 22, 32, 42]


def test_ranks_joined_one_group(ranks):
    for r, seen in enumerate(ranks):
        assert (seen["rank"], seen["world_size"], seen["is_primary"]) == (r, 2, r == 0)
        assert seen["mesh"] == (r, 2, 2)
        assert "does not split into pairs over 2 processes" in seen["odd batch"]


# ---------------------------------------------------------------------------
# The data-parallel step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["unfused", "fused"])
def test_world_2_step_equals_the_one_process_step(ranks, name):
    """(unfused) mixup 1.0, drop path 0.1, SpecAugment: every draw is made
    for the global batch and sliced; (fused) the fused training blocks
    (their plain versions here), drop path 0 (each rank draws its own drop
    path on that route). Rank 1 started from other weights: the trainer
    broadcast rank 0's. Both ranks end bit-equal to each other."""
    loss, want = _one_process(name)
    a, b = ranks[0][name], ranks[1][name]
    for k in want:
        np.testing.assert_array_equal(a["start"][k], b["start"][k], err_msg=k)
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)
        np.testing.assert_allclose(a["state"][k], want[k], atol=1e-5, rtol=0, err_msg=k)
    assert a["loss"] == b["loss"]
    np.testing.assert_allclose(a["loss"], loss, rtol=1e-5)
    moved = max(float(np.abs(a["state"][k] - a["start"][k]).max()) for k in BUFFERS)
    assert moved > 1e-3  # bn0's statistics took the step's batch moments
    assert a["collective_ms"] >= 0.0


@pytest.mark.parametrize("name", ["unfused", "fused"])
def test_world_2_gradients_equal_the_one_process_gradients(ranks, name):
    """The averaged gradients each rank's step left in ``.grad`` (the
    all-reduce of its rows' gradients) against the one-process step's on
    the global batch: bit-equal across ranks, and each leaf within rtol
    1e-5 of its norm (the loss's constant). Only the order of the sums
    differs; the worst leaf is bn0's scale, a sum over every frame of the
    batch with much cancellation: 1.35e-06 of its norm, measured here."""
    _, _, want = _one_process(name, grads=True)
    a, b = ranks[0][name]["grad"], ranks[1][name]["grad"]
    assert sorted(a) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.linalg.norm(a[k] - want[k]) <= 1e-5 * np.linalg.norm(want[k]), k


def test_world_2_step_matches_the_jax_package_on_a_2_device_mesh(ranks):
    """The JAX package's Trainer on a 2-device CPU mesh with the port's
    weights carried across: f32, no SpecAugment, mixup or drop path."""
    model = W.case_model("jax")
    params = jax_params_from_state_dict(model.state_dict())
    mkw, tkw, _, _ = W.CASES["jax"]
    jcfg = JaxConfig(**{k: v for k, v in mkw.items() if k != "spec_augment"},
                     augment=JaxAugmentConfig(use_spec_augment=False))
    jtr = JT.Trainer(jcfg, JT.TrainConfig(**tkw), jax.tree_util.tree_map(jnp.asarray, params),
                     mesh=jax_get_mesh(jax.devices()[:2]))
    jloss = jtr.step(*W.case_batch("jax"))
    got = ranks[0]["jax"]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    bn = jtr.state.params["bn0"]
    np.testing.assert_allclose(got["state"]["bn0.running_mean"], np.asarray(bn["mean"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["state"]["bn0.running_var"], np.asarray(bn["var"]),
                               rtol=1e-5)


def test_no_process_group_no_collective():
    """mesh=None and a mesh without a group give the one-process step bit
    for bit and time no collective."""
    name = "unfused"
    loss, want = _one_process(name)
    model = W.case_model(name)
    trainer = Trainer(model, W.case_train_config(name), mesh=M.get_mesh(["cpu"]))
    assert trainer.step(*W.case_batch(name)) == loss
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert trainer.collectives.calls == 0 and trainer.collectives.ms() == 0.0


@pytest.mark.parametrize("name", ["unfused", "fused"])
def test_a_group_of_one_is_the_one_process_step_bit_for_bit(tmp_path, name):
    """In a process group of one (what torchrun with one process gives),
    every collective runs and changes nothing: the step is the one-process
    step bit for bit, bn0's statistics included."""
    loss, want = _one_process(name)
    assert dist.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        model = W.case_model(name)
        trainer = Trainer(model, W.case_train_config(name), mesh=M.get_mesh(["cpu"]))
        assert trainer.step(*W.case_batch(name)) == loss
        assert trainer.collectives.calls == 3  # bn0's mean and variance, the gradients
    finally:
        torch.distributed.destroy_process_group()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_collective_timer_holds_a_bounded_number_of_events(monkeypatch):
    """On the card the timer records an event pair per collective. A
    training run that never reads it (the CLI reads it only at its log
    lines) must not pile them up: completed pairs fold into a running sum,
    and beyond MAX_PENDING unread pairs the oldest is waited for. Stand-in
    events here: the device never catches up unless waited for."""

    class Event:
        def __init__(self, enable_timing=False):
            self.done = False

        def record(self, stream=None):
            pass

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

        def elapsed_time(self, end):
            assert end.done
            return 0.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    timer = CollectiveTimer(torch.device("cuda"))
    timed = timer(lambda ts: ts)
    steps = 1000
    for _ in range(3 * steps):  # 3 collectives a step
        timed([])
        assert len(timer.pending) <= CollectiveTimer.MAX_PENDING
    assert timer.calls == 3 * steps
    assert timer.ms() == 0.5 * 3 * steps and not timer.pending
    assert timer.ms() == 0.0


def test_collective_time_is_read_at_each_log_line(tmp_path, caplog):
    """Trainer.train in a group of one: each log line reads the collectives'
    ms (and so empties the timer)."""
    import logging

    name = "unfused"
    wav, target = W.case_batch(name)
    assert dist.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        trainer = Trainer(W.case_model(name), W.case_train_config(name),
                          mesh=M.get_mesh(["cpu"]))
        with caplog.at_level(logging.INFO):
            trainer.train([{"waveform": wav, "target": target}] * 3, log_interval=1)
    finally:
        torch.distributed.destroy_process_group()
    lines = [r.getMessage() for r in caplog.records if "collectives" in r.getMessage()]
    assert len(lines) == 3 and trainer.collectives.calls == 9
    assert trainer.collectives.total_ms == 0.0


# ---------------------------------------------------------------------------
# Replicas: the Evaluator and the service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def atto():
    from audioset_convnext_inf_torch.models import convnext_atto

    with pytest.warns(UserWarning, match="auto-switched"):
        model = convnext_atto(compute_dtype=torch.bfloat16, seed=4, device="cpu")
    rng = np.random.RandomState(1)
    pcm = (rng.randn(12, 16000) * 3000).astype(np.int16)
    target = (rng.rand(12, 527) < 0.1).astype(np.float32)
    return model, pcm, target


def test_sharded_evaluator_equals_one_device(atto):
    """12 clips in batches of 8 (the last padded from 4) over two replicas:
    bit-equal to the one-device forward of each replica's block of 4 rows,
    and within 2^-8 of the one-device Evaluator's batches of 8. Not
    bit-equal there: PyTorch's CPU GEMMs choose their blocking by the
    product's row count (batch x pixels), so a 4-row and an 8-row batch sum
    a row's products in other orders, and a bf16 rounding downstream can
    move by one bf16 ulp (2^-8 relative); measured here: 6e-8."""
    from audioset_convnext_inf_torch.data import DataLoader
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator

    model, pcm, target = atto

    class Memory:
        def __getitem__(self, meta):
            return {"waveform": pcm[meta["i"]], "target": target[meta["i"]]}

    def loader():
        batches = [[{"i": i} for i in range(s, min(s + 8, 12))] for s in (0, 8)]
        return DataLoader(Memory(), batches, num_workers=2, pad_to_batch_size=8)

    one = Evaluator(model, device="cpu").infer_probs(loader())
    two = Evaluator(model, devices=["cpu", "cpu"]).infer_probs(loader())
    assert two["clipwise_output"].shape == (12, 527)
    np.testing.assert_array_equal(two["target"], target)
    blocks = np.concatenate([model.forward(np.pad(pcm[s:s + 4], ((0, 4 - len(pcm[s:s + 4])),
                                                                 (0, 0))))
                             ["clipwise_output"].numpy()[:len(pcm[s:s + 4])]
                             for s in range(0, 12, 4)])
    np.testing.assert_array_equal(two["clipwise_output"], blocks)
    np.testing.assert_allclose(two["clipwise_output"], one["clipwise_output"], atol=2.0 ** -8,
                               rtol=0)
    with pytest.raises(ValueError, match="lives on"):
        Evaluator(model, devices=["meta"])


def test_sharded_model_behind_the_service_answers_each_clip_with_its_row(atto):
    """ShardedModel over two CPU replicas behind InferenceService (batch
    4): each of 12 clips gets its own row of the batch it rode in, and each
    batch's output is bit-equal to the one-device forward of its two
    blocks of 2 rows."""
    from concurrent.futures import ThreadPoolExecutor

    from audioset_convnext_inf_torch.engine.service import InferenceService, ShardedModel

    model, pcm, _ = atto
    sharded = ShardedModel(model, devices=["cpu", "cpu"])
    assert sharded.device == torch.device("cpu") and sharded.cfg is model.cfg
    seen = []

    class Recording:
        device = sharded.device

        def forward(self, x):
            out = sharded.forward(x)
            seen.append((np.array(x), out["clipwise_output"].numpy().copy()))
            return out

    with InferenceService(Recording(), batch_size=4, max_wait_ms=2, clip_samples=16000,
                          pcm_int16=True) as svc:
        seen.clear()  # the warm-up's
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda i: svc.tag(pcm[i], timeout=60)["clipwise_output"],
                                range(12)))
    assert sum(int((x != 0).any(axis=1).sum()) for x, _ in seen) == 12
    for i, probs in enumerate(got):
        hits = [(x, out, r) for x, out in seen for r in range(len(x)) if (x[r] == pcm[i]).all()]
        assert len(hits) == 1, i
        x, out, r = hits[0]
        np.testing.assert_array_equal(probs, out[r])
        np.testing.assert_array_equal(out, np.concatenate(
            [model.forward(x[k:k + 2])["clipwise_output"].numpy() for k in (0, 2)]))
    emb = sharded.forward_scene_embeddings(pcm[:3])  # padded to 4, trimmed to 3
    assert emb.shape == (3, model.cfg.dims[-1])
    assert torch.equal(emb, torch.cat([
        model.forward_scene_embeddings(x)
        for x in (pcm[:2], np.stack([pcm[2], np.zeros(16000, np.int16)]))])[:3])


# ---------------------------------------------------------------------------
# cli/train.py at world 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """What each of 2 ranks saw running cli/train.py::train."""
    return W.spawn(W.train_cli, 2, str(tmp_path_factory.mktemp("cli")))


def test_train_cli_at_world_2(cli_ranks):
    """Each rank in its own workspace: only rank 0 writes checkpoints,
    statistics and the metric log, and only it evaluates; each rank reads
    only its own rows of each batch; the sampler states and the parameters
    end bit-equal on both ranks."""
    a, b = cli_ranks
    assert "checkpoints/convnext_atto/4_iterations/state.pkl" in a["files"]
    assert "statistics/convnext_atto/statistics.pkl" in a["files"]
    assert not any(f.startswith(("checkpoints", "statistics", "metrics")) for f in b["files"])
    assert a["eval_read"] and not b["eval_read"]
    from audioset_convnext_inf_torch.data import BalancedTrainSampler

    sampler = iter(BalancedTrainSampler.from_index(W.MemoryDataset(32, 1).index(), 8, None, 5))
    batches = [[m["index_in_hdf5"] for m in next(sampler)] for _ in range(4)]
    assert a["read"][:16] == [i for m in batches for i in m[:4]]
    assert b["read"][:16] == [i for m in batches for i in m[4:]]
    assert len(a["losses"]) == len(b["losses"]) == 4 and a["losses"] == b["losses"]
    assert a["in_group"] and b["in_group"]
    for x, y in zip(jax.tree_util.tree_leaves(a["sampler_state"]),
                    jax.tree_util.tree_leaves(b["sampler_state"])):
        np.testing.assert_array_equal(x, y)
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


def test_train_cli_at_world_2_equals_one_process(cli_ranks, tmp_path, monkeypatch):
    """The CLI's own path (each rank loads its rows of each batch and steps
    on them) against the same CLI run in one process: the 4 losses within
    rtol 1e-5 and the parameters and bn0's statistics within atol 1e-5,
    the constants of the one-step comparison above, after 4 steps
    (measured here: losses 8.5e-08 apart, parameters 1.9e-06)."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    one = W.run_train_cli(str(tmp_path / "one"))
    a = cli_ranks[0]
    assert not one["in_group"] and len(one["losses"]) == 4
    np.testing.assert_allclose(a["losses"], one["losses"], rtol=1e-5)
    for k in one["params"]:
        np.testing.assert_allclose(a["params"][k], one["params"][k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_serve_mesh_arguments():
    """--mesh serves over every card: it takes no --device other than the
    card and no --bundle (bundles wait for the export slice), and without a
    card it raises instead of serving on the CPU."""
    from audioset_convnext_inf_torch.cli import serve as serve_cli
    from audioset_convnext_inf_torch.engine.service import ShardedModel

    assert serve_cli.parse_args(["--mesh"]).mesh
    for argv in (["--mesh", "--device", "cpu"], ["--mesh", "--bundle", "b"]):
        with pytest.raises(SystemExit):
            serve_cli.parse_args(argv)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedModel(object())
