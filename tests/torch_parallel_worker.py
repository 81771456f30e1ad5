"""Worker processes of tests/test_torch_parallel.py (the port's data
parallelism on the CPU, gloo backend). Each spawned process joins a process
group through a file rendezvous, runs one scenario and pickles what it saw
to ``<out>/rank<r>.pkl``. It imports neither JAX nor the JAX package; the
parent test compares what the ranks saw with one process and with JAX.
"""

import os
import pickle

import numpy as np
import torch

# The trainer cases: (model config, train config, clips, clip samples).
# "unfused" and "fused" are the one-process comparisons; "jax" has the
# switches under which the JAX package's train step is the port's.
CASES = {
    "unfused": (dict(depths=(1, 1, 1, 1), dims=(32, 64, 128, 256), drop_path_rate=0.1),
                dict(max_lr=1e-3, total_steps=100, mixup_alpha=1.0, seed=7), 16, 16000),
    "fused": (dict(depths=(1, 1, 1, 1), dims=(32, 64, 128, 256), drop_path_rate=0.0,
                   block_impl="xla_approx", fused_train_blocks=True),
              dict(max_lr=1e-3, total_steps=100, mixup_alpha=1.0, seed=7), 16, 16000),
    "jax": (dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), drop_path_rate=0.0,
                 spec_augment=False),
            dict(max_lr=1e-3, total_steps=100, seed=0), 8, 16000),
}


def case_model(name: str, seed: int = 0):
    """The case's model on the CPU, from ``seed``, with seeded gamma (at
    init gamma is 1e-6 and every block is nearly the identity)."""
    from audioset_convnext_inf_torch.config import AugmentConfig, ConvNeXtConfig
    from audioset_convnext_inf_torch.models import ConvNeXt

    kw = dict(CASES[name][0])
    spec = kw.pop("spec_augment", True)
    model = ConvNeXt(ConvNeXtConfig(**kw, augment=AugmentConfig(use_spec_augment=spec)),
                     device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for stage in model.stages:
            for blk in stage:
                blk.gamma.copy_(torch.rand(blk.gamma.shape, generator=g) * 0.9 + 0.1)
    return model


def case_batch(name: str):
    _, _, clips, samples = CASES[name]
    rng = np.random.RandomState(3)
    wav = (rng.randn(clips, samples) * 0.1).astype(np.float32)
    target = (rng.rand(clips, 527) < 0.05).astype(np.float32)
    return wav, target


def case_train_config(name: str):
    from audioset_convnext_inf_torch.engine.trainer import TrainConfig

    return TrainConfig(**CASES[name][1])


def _join(rank: int, world: int, rendezvous: str) -> None:
    from audioset_convnext_inf_torch.parallel import dist

    torch.set_num_threads(1)
    assert dist.initialize_distributed(init_method=f"file://{rendezvous}", world_size=world,
                                       rank=rank, device="cpu")


def trainer_cases(rank: int, world: int, rendezvous: str, out: str) -> None:
    """Each case: a model from another seed on rank 1 (the trainer
    broadcasts rank 0's weights), one Trainer step on this rank's rows of
    the global batch; the averaged gradients the step left in ``.grad``."""
    _join(rank, world, rendezvous)
    from audioset_convnext_inf_torch.engine.trainer import Trainer
    from audioset_convnext_inf_torch.parallel import dist, get_mesh, shard_batch

    mesh = get_mesh(["cpu"])
    seen = {"rank": dist.rank(), "world_size": dist.world_size(),
            "is_primary": dist.is_primary(), "mesh": (mesh.rank, mesh.world_size, mesh.size)}
    for name in CASES:
        model = case_model(name, seed=rank)
        trainer = Trainer(model, case_train_config(name), mesh=mesh)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        loss = trainer.step(*shard_batch(case_batch(name), mesh))
        seen[name] = {"loss": loss, "start": {k: v.numpy() for k, v in start.items()},
                      "state": {k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()},
                      "grad": {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
                      "collective_ms": trainer.collectives.ms()}
    odd = Trainer(case_model("unfused"), case_train_config("unfused"), mesh=mesh)
    try:  # 6 clips: 3 a rank, 1.5 pairs
        odd.step(*shard_batch(tuple(a[:6] for a in case_batch("unfused")), mesh))
    except ValueError as e:
        seen["odd batch"] = str(e)
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(seen, f)


class MemoryDataset:
    """AudioSetDataset's contract over seeded arrays, recording what it reads."""

    def __init__(self, n: int, seed: int):
        rng = np.random.RandomState(seed)
        self.pcm = (rng.randn(n, 16000) * 3000).astype(np.int16)
        self.target = (rng.rand(n, 527) < 0.05).astype(np.float32)
        self.target[np.arange(n), rng.randint(0, 527, n)] = 1.0
        self.read = []

    def __getitem__(self, meta):
        i = meta["index_in_hdf5"]
        self.read.append(i)
        return {"audio_name": f"clip{i:04d}", "waveform": self.pcm[i], "target": self.target[i]}

    def index(self):
        n = len(self.pcm)
        return {"audio_names": np.array([f"clip{i:04d}" for i in range(n)]),
                "hdf5_paths": np.array(["memory"] * n), "indexes_in_hdf5": np.arange(n),
                "targets": self.target}


def train_cli(rank: int, world: int, rendezvous: str, out: str) -> None:
    """:func:`run_train_cli` at world 2, each rank in its own workspace."""
    _join(rank, world, rendezvous)
    os.environ["WANDB_MODE"] = "disabled"
    seen = run_train_cli(os.path.join(out, f"ws{rank}"))
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(seen, f)


def run_train_cli(ws: str) -> dict:
    """cli/train.py::train over in-memory data in workspace ``ws``, in this
    process's group if it is in one: 4 steps of convnext_atto on
    half-second clips, global batch 4 (8 clips in with mixup), an
    evaluation and a checkpoint every 2 steps; one loader thread, so the
    dataset reads in the sampler's order."""
    from audioset_convnext_inf_torch.cli import train as cli

    data, edata = MemoryDataset(32, 1), MemoryDataset(8, 2)
    args = cli.parse_args([
        "--train-indexes", "memory", "--model", "convnext_atto", "--batch-size", "4",
        "--sampler", "balanced", "--mixup-alpha", "1.0", "--early-stop", "4",
        "--eval-interval", "2", "--checkpoint-interval", "2", "--eval-batch-size", "4",
        "--num-workers", "1", "--workspace", ws, "--total-steps", "100", "--seed", "5",
        "--device", "cpu"])
    losses = []
    trainer = cli.train(args, data.index(), {"test": edata.index()}, data, edata,
                        on_step=lambda it, loss: losses.append(loss))
    return {"files": sorted(os.path.relpath(os.path.join(d, f), ws)
                            for d, _, fs in os.walk(ws) for f in fs),
            "sampler_state": trainer.last_sampler_state, "read": data.read,
            "eval_read": edata.read, "losses": losses, "in_group": torch.distributed.is_initialized(),
            "params": {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}}


def spawn(fn, world: int, out: str):
    """Run ``fn(rank, world, rendezvous, out)`` in ``world`` fresh processes;
    returns what each rank pickled."""
    import torch.multiprocessing as mp

    rendezvous = os.path.join(out, "rendezvous")
    mp.start_processes(fn, args=(world, rendezvous, out), nprocs=world, start_method="spawn")
    seen = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            seen.append(pickle.load(f))
    return seen
