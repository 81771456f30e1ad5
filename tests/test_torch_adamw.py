"""The AdamW kernel's plan and wrapper (ops/adamw.py, csrc/adamw.cu).

On the CPU: the launch plan covers every value of every leaf once, carries
the decay mask and keeps each launch's parameters under 4 KB; the wrapper
sends CPU tensors to the plain version and refuses mixed devices. On the
card (marker ``cuda``): the kernel gives the plain version's bits, in
every optimizer the trainer builds, and ``Trainer.step_async`` updates
through it. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_adamw.py
"""

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch.engine import trainer as T
from audioset_convnext_inf_torch.ops import adamw as A


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


@pytest.fixture(scope="module")
def tiny_leaves():
    """convnext_tiny's parameters by name, on the CPU."""
    from audioset_convnext_inf_torch.models import convnext_tiny

    return {n: p.detach() for n, p in convnext_tiny(device="cpu").named_parameters()}


# leaf sizes around the chunk's edges, a leaf of none, one of a single value
RAGGED = [1, 3, 5, 0, 2047, 2048, 2049, 4095, 4097, 10_001, 96, 7, 6147]


def _cover(sizes, decay):
    """Each value's count of blocks that update it, and each leaf's decay
    flag as the plan's blocks carry it."""
    seen = [np.zeros(n, np.int32) for n in sizes]
    flags = {}
    for launch in A.launch_plan(sizes, decay):
        assert len(launch.sizes) <= A.MAX_LEAVES
        assert launch.start[0] == 0 and len(launch.start) == len(launch.sizes) + 1
        for b in range(launch.start[-1]):
            leaf, first, count = A.block_values(launch, b)
            assert 0 < count <= A.CHUNK and first % A.CHUNK == 0
            seen[launch.first + leaf][first:first + count] += 1
            flags.setdefault(launch.first + leaf, set()).add(launch.decay[leaf])
    return seen, flags


@pytest.mark.parametrize("case", ["convnext_tiny", "ragged", "many"])
def test_the_plan_updates_every_value_of_every_leaf_once(case, tiny_leaves):
    if case == "convnext_tiny":
        sizes = [p.numel() for p in tiny_leaves.values()]
        decay = [p.ndim > 1 for p in tiny_leaves.values()]
    elif case == "ragged":
        sizes, decay = RAGGED, [i % 3 == 0 for i in range(len(RAGGED))]
    else:  # more leaves than two launches hold
        sizes = [(37 * i) % 5000 for i in range(2 * A.MAX_LEAVES + 7)]
        decay = [i % 2 == 1 for i in range(len(sizes))]
    seen, flags = _cover(sizes, decay)
    assert all((s == 1).all() for s in seen)
    assert {i: {d} for i, d in enumerate(decay) if sizes[i]} == flags
    plan = A.launch_plan(sizes, decay)
    assert len(plan) == -(-len(sizes) // A.MAX_LEAVES)
    assert [i for la in plan for i in range(la.first, la.first + len(la.sizes))] == list(
        range(len(sizes)))


def test_convnext_tiny_takes_two_launches_of_even_halves(tiny_leaves):
    """184 leaves, 59 of them decaying: two launches of 92, the blocks
    ceil(n / CHUNK) a leaf."""
    sizes = [p.numel() for p in tiny_leaves.values()]
    decay = [p.ndim > 1 for p in tiny_leaves.values()]
    assert (len(sizes), sum(sizes), sum(decay)) == (184, 28_222_767, 59)
    plan = A.launch_plan(sizes, decay)
    assert [len(la.sizes) for la in plan] == [92, 92]
    assert sum(la.start[-1] for la in plan) == sum(-(-n // A.CHUNK) for n in sizes)
    assert [sum(la.decay) for la in plan] == [sum(decay[:92]), sum(decay[92:])]


def test_a_launchs_parameters_stay_under_the_limit():
    """The table of MAX_LEAVES leaves and the step's scalars fit the 4 KB
    that any toolkit takes; one more leaf would not."""
    assert A.param_bytes() == 3980 <= A.PARAM_LIMIT
    assert A.param_bytes(A.MAX_LEAVES + 3) > A.PARAM_LIMIT


@pytest.mark.parametrize("sizes,decay,match", [
    ([4, 5], [True], "decay flags"),
    ([-1], [False], "values"),
    ([2 ** 31], [False], "values"),
])
def test_the_plan_refuses_what_the_kernel_cannot_take(sizes, decay, match):
    with pytest.raises(ValueError, match=match):
        A.launch_plan(sizes, decay)


def _leaves(rng, sizes, device="cpu"):
    """p, g, m, v of each size, seeded: v non-negative, g at several scales
    (tiny ones square to subnormals), some of it exactly zero."""
    out = []
    for i, n in enumerate(sizes):
        g = rng.randn(n) * 10.0 ** rng.randint(-22, 1)
        g[rng.rand(n) < 0.05] = 0.0
        vals = [rng.randn(n), g, rng.randn(n) * 1e-3, np.abs(rng.randn(n)) * 1e-6]
        out.append([torch.from_numpy(x.astype(np.float32)).to(device) for x in vals])
    return [list(t) for t in zip(*out)] if out else [[], [], [], []]


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    p, g, m, v = _leaves(rng, RAGGED)
    decay = [i % 2 == 0 for i in range(len(RAGGED))]
    copies = [[t.clone() for t in group] for group in (p, m, v)]
    before = A.adamw_update_.launches
    assert A.adamw_update_(p, g, m, v, decay, 1e-3, 0.05, 0.1, 0.001) == 0
    A.adamw_update_reference(copies[0], g, copies[1], copies[2], decay, 1e-3, 0.05, 0.1, 0.001)
    assert A.adamw_update_.launches == before
    for got, want in zip((p, m, v), copies):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mixed_devices_and_uneven_lists_are_refused():
    rng = np.random.RandomState(1)
    p, g, m, v = _leaves(rng, [8, 8])
    with pytest.raises(ValueError, match="tensors on meta and cpu"):
        A.adamw_update_(p, [g[0], torch.empty(8, device="meta")], m, v, [True, False],
                        1e-3, 0.0, 0.1, 0.001)
    with pytest.raises(ValueError, match="2 parameters, 1 gradients"):
        A.adamw_update_(p, g[:1], m, v, [True, False], 1e-3, 0.0, 0.1, 0.001)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": dict(),
    "adam": dict(optimizer="adam"),
    "adamw_wd_schedule": dict(use_wd_schedule=True, wd_constant_cooldown=False),
}


def _plain_steps(params, grads, cfg, steps):
    """The plain version on the card over ``steps`` updates, from fresh
    moments, with the Optimizer's schedules and decay mask."""
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    decay = T._wd_mask(params) if cfg.optimizer == "adamw" else {}
    lr = T.onecycle_lr(cfg)
    wd = T.wd_schedule(cfg) if cfg.use_wd_schedule else (lambda step: cfg.weight_decay)
    names = list(params)
    out = []
    for k in range(steps):
        t = k + 1
        A.adamw_update_reference([params[n] for n in names], [grads[k][n] for n in names],
                                 [mu[n] for n in names], [nu[n] for n in names],
                                 [bool(decay.get(n)) for n in names], lr(k), wd(k),
                                 1 - A.B1 ** t, 1 - A.B2 ** t)
        out.append({n: (params[n].clone(), mu[n].clone(), nu[n].clone()) for n in names})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_the_kernel_gives_the_plain_versions_bits_on_convnext_tiny(name, tiny_leaves):
    """The Optimizer on the card against the plain version on the card over
    5 updates of convnext_tiny's 184 leaves with seeded gradients: p, m and
    v bit-equal after every update; every update fused, two launches each."""
    _need_card()
    rng = np.random.RandomState(2)
    cfg = T.TrainConfig(max_lr=1e-2, total_steps=8, weight_decay=0.05, **OPTIMIZERS[name])
    start = {n: p.cuda() for n, p in tiny_leaves.items()}
    grads = [{n: torch.from_numpy((rng.randn(*p.shape) * 10.0 ** rng.randint(-12, 1))
                                  .astype(np.float32)).cuda() for n, p in start.items()}
             for _ in range(5)]
    want = _plain_steps({n: p.clone() for n, p in start.items()}, grads, cfg, 5)
    params = {n: p.clone() for n, p in start.items()}
    opt = T.Optimizer(params, cfg)
    before = A.adamw_update_.launches
    for k in range(5):
        assert opt.step(grads[k])
        torch.cuda.synchronize()
        for n, (p, m, v) in want[k].items():
            assert torch.equal(params[n], p), (k, n, "p")
            assert torch.equal(opt.mu[n], m), (k, n, "m")
            assert torch.equal(opt.nu[n], v), (k, n, "v")
    assert (opt.fused_updates, opt.loop_updates) == (5, 0)
    assert A.adamw_update_.launches - before == 10
    assert sum(not torch.equal(params[n], start[n]) for n in start) == len(start)


@pytest.mark.cuda
def test_the_kernel_gives_the_plain_versions_bits_on_ragged_and_unaligned_leaves():
    """Leaves around the chunk's edges, one of none, views that start one
    value past an aligned address (the scalar route), and more leaves than
    two launches hold: bit-equal over 5 updates."""
    _need_card()
    rng = np.random.RandomState(3)
    sizes = RAGGED + [(37 * i) % 3000 for i in range(2 * A.MAX_LEAVES)]
    decay = [i % 3 != 1 for i in range(len(sizes))]
    p, _, m, v = _leaves(rng, sizes, "cuda")
    for i in (4, 9, len(RAGGED) + 5):  # unaligned: the same values one float on
        p[i], m[i], v[i] = (torch.cat([torch.zeros(1, device="cuda"), t])[1:]
                            for t in (p[i], m[i], v[i]))
        assert p[i].data_ptr() % 16 != 0 and p[i].is_contiguous()
    ref = [[t.clone() for t in group] for group in (p, m, v)]
    for k in range(5):
        g = _leaves(rng, sizes, "cuda")[1]
        t = k + 1
        args = (decay, 3e-3 * t, 0.02, 1 - A.B1 ** t, 1 - A.B2 ** t)
        assert A.adamw_update_(p, g, m, v, *args) == 3
        A.adamw_update_reference(ref[0], g, ref[1], ref[2], *args)
        torch.cuda.synchronize()
        for got, want in zip((p, m, v), ref):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), k


@pytest.mark.cuda
def test_the_kernel_library_agrees_with_the_plan_and_refuses_other_tables():
    _need_card()
    import ctypes

    lib = A.load_library()
    assert lib.adamw_chunk() == A.CHUNK and lib.adamw_max_leaves() == A.MAX_LEAVES
    assert lib.adamw_param_bytes() == A.param_bytes()
    x = [torch.zeros(3000, device="cuda") for _ in range(4)]
    ptrs = (ctypes.c_ulonglong * 4)(*(t.data_ptr() for t in x))
    n, decay = (ctypes.c_int * 1)(3000), (ctypes.c_ubyte * 1)(1)
    stream = torch.cuda.current_stream().cuda_stream
    for start, leaves, want in (((0, 2), 1, 0), ((0, 1), 1, 1), ((1, 3), 1, 1),
                                ((0, 2), 0, 1), ((0, 2), A.MAX_LEAVES + 1, 1)):
        err = lib.adamw_update(ptrs, n, (ctypes.c_int * 2)(*start), decay, leaves,
                               *([0.5] * 9), stream)
        assert err == want, (start, leaves)  # 1: cudaErrorInvalidValue
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_the_wrapper_refuses_bf16_strided_and_mixed_device_leaves():
    _need_card()
    rng = np.random.RandomState(4)
    p, g, m, v = _leaves(rng, [64, 64], "cuda")
    args = ([True, False], 1e-3, 0.01, 0.1, 0.001)
    with pytest.raises(TypeError, match="bfloat16"):
        A.adamw_update_(p, [g[0], g[1].bfloat16()], m, v, *args)
    with pytest.raises(ValueError, match="non-contiguous"):
        A.adamw_update_(p, [g[0], torch.zeros(128, device="cuda")[::2]], m, v, *args)
    with pytest.raises(ValueError, match="tensors on cpu and cuda"):
        A.adamw_update_(p, g, [m[0], m[1].cpu()], v, *args)


@pytest.mark.cuda
def test_trainer_steps_on_the_card_update_through_the_kernel():
    """Three ``Trainer.step_async`` calls of convnext_atto (f32, unfused
    blocks) on the card: every update fused, at most 3 launches each."""
    _need_card()
    from audioset_convnext_inf_torch.models import convnext_atto

    model = convnext_atto(device="cuda", seed=0)
    tr = T.Trainer(model, T.TrainConfig(mixup_alpha=1.0))
    rng = np.random.RandomState(5)
    pcm = (rng.randn(4, 32000) * 3000).astype(np.int16)
    target = (rng.rand(4, 527) < 0.02).astype(np.float32)
    before = A.adamw_update_.launches
    for _ in range(3):
        tr.step_async(pcm, target)
    torch.cuda.synchronize()
    per = len(A.launch_plan([p.numel() for p in model.parameters()],
                            [False] * len(list(model.parameters()))))
    assert per <= 3
    assert A.adamw_update_.launches - before == 3 * per
    assert (tr.optimizer.fused_updates, tr.optimizer.loop_updates) == (3, 0)
