"""Profiling and throughput instrumentation, on PyTorch's own tools.

The port's counterpart of the JAX package's ``utils/profiling.py`` (the
reference has wall-clock prints and a forward-hook FLOP counter,
pytorch_utils.py:179-312):

 - :func:`trace`: a ``torch.profiler`` run that writes a Chrome trace into
   ``log_dir``;
 - :func:`span`: a named range of the program, seen by a profiler that is
   running and costing one check when none is;
 - :func:`count_flops`: ``torch.utils.flop_counter.FlopCounterMode`` over one
   call, with the per-op counts (the fused block kernel has a formula of its
   own, registered here, since the counter cannot see inside a custom op);
 - :func:`count_parameters`;
 - :func:`profile_ops`: time by op over a few calls: the card's kernels
   from the trace's device events, or the CPU's operators by self time.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``with trace(dir):`` profiles the block (CPU, and the card where there
    is one) and writes ``trace.json`` (Chrome trace format) into ``dir``
    (default: ``torch-trace`` under the temporary directory). Yields the
    directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[Dict[str, Any]] = None):
    """``with span(name, args):`` marks a range of the program for a
    ``torch.profiler`` that is running: a function-scope record function,
    which the Chrome trace holds as a ``cpu_op`` event named ``name``, on
    the clock of the card's kernel and copy events, with ``args`` (ints,
    floats, strings) among its arguments where the profiler records inputs
    (``record_shapes=True``). So each device interval can be put down
    to the span open on the host when it was launched.

    With no profiler running, and while ``torch.export`` or
    ``torch.compile`` traces, it is one shared null context: an untraced run
    pays a single check, and no traced program holds a profiler op.

    The port's spans: ``train.step`` (``step``), and within it
    ``train.h2d``, ``train.forward``, ``train.backward``,
    ``train.allreduce`` (with a process group), ``train.optimizer``;
    ``eval.wait_batch`` and ``eval.launch`` (``batch``); the model's
    ``model.frontend`` and ``model.stage1`` ... ``model.stage4``; the
    fused blocks' host work before each launch, ``fused_block.prep`` and
    ``fused_block_bwd.prep``."""
    if not torch.autograd._profiler_enabled() or torch.compiler.is_compiling():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, (), args or {})


_FLOP_FORMULAS_REGISTERED = False


def _register_fused_block_flops() -> None:
    """The fused block's FLOPs: per output pixel and channel, 49
    multiply-adds of the 7x7 depthwise conv and 8C of the two pointwise
    products (C -> 4C -> C), 2 FLOPs each."""
    global _FLOP_FORMULAS_REGISTERED
    if _FLOP_FORMULAS_REGISTERED:
        return
    from torch.utils.flop_counter import register_flop_formula

    from audioset_convnext_inf_torch.ops import fused_block as FB

    def formula(x_shape, *args, out_shape=None, **kwargs) -> int:
        b, h, w, c = x_shape
        return 2 * b * h * w * c * (FB.K * FB.K + 8 * c)

    ops = getattr(torch.ops, FB.OPS)
    register_flop_formula([ops.fused_block, ops.fused_block_save])(formula)
    _FLOP_FORMULAS_REGISTERED = True


def count_flops(fn: Callable, *example_args, **kwargs) -> Dict[str, Any]:
    """FLOPs of one call ``fn(*example_args, **kwargs)`` by
    ``FlopCounterMode``: {'flops': total, 'flops_by_op': {op name: FLOPs}}.
    The counter knows matrix products, convolutions and attention, and the
    fused block by its registered formula; elementwise work is not counted.
    Keys it cannot measure (bytes accessed) are left out."""
    from torch.utils.flop_counter import FlopCounterMode

    _register_fused_block_flops()
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args, **kwargs)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "flops_by_op": by_op}


def count_parameters(params) -> int:
    """Elements of a module's parameters, or of a state dict's or an
    iterable's tensors and arrays."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        params = params.values()
    return sum(int(x.numel()) if isinstance(x, torch.Tensor) else int(x.size)
               for x in params if hasattr(x, "numel") or hasattr(x, "size"))


def _kernel_short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameter list."""
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip()
    return short.split(" ")[-1] if short else name


def profile_ops(fn: Callable, *example_args, iters: int = 3) -> List[dict]:
    """Time by op of ``fn(*example_args)`` over ``iters`` calls after one
    untimed call, sorted by time: rows {'name', 'category', 'ms_per_iter',
    'count_per_iter', 'long_name'}. Where the arguments or the work are on
    the card, the rows are its device events (kernels, copies, sets), by
    their kernel names; on the CPU they are the operators by self time, so
    that nested operators are not counted twice. The enclosing record of
    the run is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    fn(*example_args)
    if cuda:
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, record_shapes=not cuda) as prof:
        for _ in range(iters):
            fn(*example_args)
        if cuda:
            torch.cuda.synchronize()
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    time_us: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    meta: Dict[str, tuple] = {}
    if device_events:
        for e in device_events:
            copy = e.name.startswith(("Memcpy", "Memset"))
            name = e.name if copy else _kernel_short_name(e.name)
            time_us[name] += e.time_range.elapsed_us()
            count[name] += 1
            meta[name] = (e.name[:6].lower() if copy else "kernel", e.name)
    else:
        for e in _cpu_events(prof.events()):
            time_us[e.name] += e.self_cpu_time_total
            count[e.name] += 1
            meta[e.name] = ("cpu_op", str(e.input_shapes) if e.input_shapes else e.name)
    rows = []
    for name, us in sorted(time_us.items(), key=lambda kv: -kv[1]):
        rows.append({"name": name, "category": meta[name][0], "ms_per_iter": us / 1e3 / iters,
                     "count_per_iter": count[name] // max(iters, 1),
                     "long_name": meta[name][1][:200]})
    return rows


def _cpu_events(events: Iterable) -> Iterable:
    from torch.autograd import DeviceType

    for e in events:
        if e.device_type == DeviceType.CPU and not e.name.startswith("ProfilerStep"):
            yield e
