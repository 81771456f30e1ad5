"""Every public top-level name of every module of the JAX package exists in
the port's module of the same path, apart from the JAX idioms listed in
ALLOWED, each with the port's counterpart and the reason.

Names are read with ``ast``, without importing either package: a module's
top-level functions, classes and assignments whose names do not start with
an underscore, and ``__version__``. On the port's side imported names count
too (a name may be re-exported from the module that defines it). Every
module has its namesake in the port but the two Pallas wrappers.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "audioset_convnext_inf_tpu"
PORT_PKG = ROOT / "audioset_convnext_inf_torch"

_ALIASES = "type aliases of the JAX package's functional style (jnp arrays, parameter pytrees)"
_FUNCTIONAL = ("JAX functional init/apply pairs over parameter pytrees; the port spells each as "
               "an nn.Module (its constructor draws the weights, its forward applies them)")
_PALLAS = ("the Pallas TPU kernel wrapper: its counterparts are ops/fused_block.py and "
           "ops/fused_block_bwd.py over csrc/*.cu")
_STEP_TIMER = ("an EMA of the step time, the wrong statistic for a measured window, which "
               "nothing called: the port times its steps by utils.profiling.span ranges that "
               "a running profiler reads")

# module path -> {name: reason}
ALLOWED = {
    "config.py": {"RuntimeConfig": "no code of either package reads it (ROADMAP, queue 1)"},
    "checkpoint/convert.py": {
        "torch_state_dict_to_params": "the port's modules hold the reference keys; "
                                      "checkpoint.jax_params_from_state_dict is the same "
                                      "conversion, named from the port's side",
        "jax_params_to_torch_state_dict": "checkpoint.state_dict_from_jax_params, the inverse",
    },
    "checkpoint/io.py": {"Params": _ALIASES},
    "engine/losses.py": {"Array": _ALIASES},
    "engine/trainer.py": {"TrainState": "the (params, opt_state, step) pytree of a functional "
                                        "step: the port's Trainer holds the model's parameters "
                                        "and its Optimizer, which keeps the state and the step"},
    "engine/transfer.py": {"Params": _ALIASES},
    "models/api.py": {"Params": _ALIASES},
    "models/convnext.py": {"Array": _ALIASES, "Params": _ALIASES,
                           "init_params": _FUNCTIONAL + " (ConvNeXtModule)"},
    "models/layers.py": {"Array": _ALIASES, **{n: _FUNCTIONAL + " (layers.init_*_ in place)"
                                               for n in ("init_batch_norm", "init_conv",
                                                         "init_layer_norm", "init_linear")}},
    "models/pann.py": {"Array": _ALIASES, "Params": _ALIASES, **{
        f"{kind}_{family}": _FUNCTIONAL + " (PannModel and its family modules)"
        for kind in ("init", "apply")
        for family in ("cnn", "cnn_next", "dainet", "leenet", "mobilenet_v1", "mobilenet_v2",
                       "res1dnet", "resnet_model", "sed", "wavegram")}},
    "models/pann_layers.py": {
        "Array": _ALIASES, "Params": _ALIASES,
        "BnCtx": "batch-norm train state threaded through apply functions: the port's "
                 "TrainCtx (pann_layers.training)",
        "KeyStream": "a stream of JAX PRNG keys: the port draws from a torch.Generator "
                     "or takes the draws handed in (forward_train's draws)",
        **{n: _FUNCTIONAL + " (ConvBlock, AttBlock, Resnet, Res1dNet, InvertedResidual, ...)"
           for n in ("att_block", "conv_block", "conv_block5x5", "conv_block_deformable",
                     "conv_block_sep", "conv_block_seppw", "dai_block", "deform_conv_apply",
                     "inverted_residual", "lee_block", "lee_block2", "pre_wav_block",
                     "res1d_block", "res1dnet_forward", "resnet_basic_block",
                     "resnet_bottleneck", "resnet_forward", "glorot_conv", "glorot_conv1d",
                     "glorot_linear", "init_att_block", "init_bn", "init_conv_block",
                     "init_conv_block5x5", "init_conv_block_deformable", "init_conv_block_sep",
                     "init_conv_block_seppw", "init_dai_block", "init_deform_conv",
                     "init_inverted_residual", "init_lee_block", "init_lee_block2",
                     "init_mb_conv_bn", "init_mb_conv_dw", "init_pre_wav_block",
                     "init_res1d_block", "init_res1dnet", "init_resnet",
                     "init_resnet_basic_block", "init_resnet_bottleneck")}},
    "ops/augment.py": {"Array": _ALIASES},
    "ops/deform_conv.py": {"Array": _ALIASES},
    "ops/fused_block_train.py": {
        "Array": _ALIASES,
        "fused_block_train": "the JAX custom VJP: the port's FusedBlockTrain autograd Function",
        "FusedTrainTiles": "the Pallas kernels' VMEM tiling: the CUDA kernels choose their "
                           "launch in ops/fused_block*.py::launch_plan",
        "bwd_geometry_ok": "a Pallas tiling check (as FusedTrainTiles)",
    },
    "ops/mixup.py": {"Array": _ALIASES},
    "ops/specaugment.py": {"Array": _ALIASES},
    "utils/profiling.py": {"StepTimer": _STEP_TIMER},
    "ops/pallas_fused_block.py": {n: _PALLAS for n in ("Array", "K", "P", "SUB",
                                                       "fused_block_hwbc")},
    "ops/pallas_fused_block_bwd.py": {n: _PALLAS for n in ("Array", "K", "P", "SUB",
                                                           "fused_block_bwd_hwbc")},
}


def _public_defs(path: Path, with_imports: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_port_has_every_public_name(module):
    allowed = ALLOWED.get(module, {})
    want = _public_defs(JAX_PKG / module, with_imports=False)
    assert set(allowed) <= want, f"stale allowlist entries: {set(allowed) - want}"
    port = PORT_PKG / module
    if module in ("ops/pallas_fused_block.py", "ops/pallas_fused_block_bwd.py"):
        assert want == set(allowed)
        return
    assert port.is_file(), f"the port has no {module}"
    missing = want - set(allowed) - _public_defs(port, with_imports=True)
    assert not missing, f"{module}: missing in the port: {sorted(missing)}"


def test_package_exports_match():
    """The ``__all__`` of the packages' ``__init__`` files are the same, but
    for what a package re-exports from a module whose name ALLOWED leaves
    out of the port (``utils.StepTimer``)."""
    left_out = {"utils/__init__.py": set(ALLOWED["utils/profiling.py"])}
    for init in ("__init__.py", "data/__init__.py", "utils/__init__.py", "ops/__init__.py"):
        def exported(pkg):
            for node in ast.parse((pkg / init).read_text()).body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                    return set(ast.literal_eval(node.value))
            return set()

        assert exported(JAX_PKG) - left_out.get(init, set()) <= exported(PORT_PKG), init
