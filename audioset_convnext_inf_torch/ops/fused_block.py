"""Fused ConvNeXt block forward: the CUDA kernel and its plain version.

``fused_block`` computes one whole ConvNeXt block (reference
pytorch/convnext.py:58-87) in the NHWC layout:

    y = x + gamma * (gelu_tanh(LN(dwconv7x7(x) + b_dw) . W1^T + b1) . W2^T + b2)

with the rounding points of the TPU kernel it replaces,
the JAX package's ``ops/pallas_fused_block.py::_kernel``: the
dwconv sum (f32, plus bias), the LN output and the GELU output each round to
the activation dtype, and the block output rounds once at the end.

The training ("save") mode of the same kernel takes a per-sample drop-path
scale ``s`` (B,), which multiplies the branch after gamma and before the
residual, and also returns ``d``, the dwconv output as rounded before the
LN, for the fused backward (``ops/fused_block_bwd.py``).

The kernel is two ``torch.library`` custom ops, ``fused_block`` (serving)
and ``fused_block_save`` (training), in the namespace ``OPS``, each with a
shape ("fake") implementation, so that ``torch.export`` and
``torch.compile`` see one node per block. On a CUDA tensor an op launches
``csrc/fused_block.cu`` (built at first use by ``ops/_build.py``) or
raises; on a CPU tensor it runs ``fused_block_reference``, the same
function in plain PyTorch. The kernel
source says what bounds it on the card and what its design does about it.
``launch_plan`` chooses the launch (pixels per thread block, channel
padding of the bf16 tiles, shared memory) from (C, dtype, pixel count); the
wrapper passes it to the kernel, which refuses a plan it cannot run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from audioset_convnext_inf_torch.ops import _build
from audioset_convnext_inf_torch.ops.precision import fp32_precision

K = 7
MAX_C = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 kernels' tiles and plan, as csrc/mma_bf16.cuh sets them for K1
# and K2 alike (the kernels refuse any other plan).
CPAD = 128  # C is padded to a multiple of this for the tiles
NH = 128  # hidden units per chunk
HLD = NH + 8  # padded row of a hidden chunk (bf16)
RING = 3 * 128 * (64 + 8)  # bf16 elements of the weight-tile ring: 3 stages of 128 x 72


def width_class(cp: int) -> int:
    """128-channel blocks the bf16 kernels' (MT, C) accumulator is sized
    for: 3 up to C=384, 6 up to 768, else 8."""
    return 3 if cp <= 384 else 6 if cp <= 768 else 8


def bf16_tiling(c: int) -> Tuple[int, int, int]:
    """(cp, mt, width class) of the bf16 kernels at C channels: C padded
    to CPAD; 64 pixels per block up to C=384 (96 accumulator registers), 32
    above (32 beat 16 at C=768 for both kernels: PERF.md, Findings)."""
    cp = -(-c // CPAD) * CPAD
    ncls = width_class(cp)
    return cp, 64 if ncls == 3 else 32, ncls


class LaunchPlan(NamedTuple):
    mt: int          # output pixels per thread block
    cp: int          # channels as the kernel's tiles see them (bf16: padded to CPAD)
    ctas: int        # thread blocks of the launch
    smem_bytes: int  # dynamic shared memory of one block
    acc_regs: int    # f32 registers per thread that hold the (mt, C) sum


def launch_plan(c: int, dtype: torch.dtype, npix: int) -> LaunchPlan:
    """The forward kernel's launch for C channels and npix = B*H*W pixels.
    bf16: the tensor-core kernel under ``bf16_tiling``. f32: the FMA
    kernel, 16 pixels per block, the (16, C) sum in shared memory."""
    if not 1 <= c <= MAX_C:
        raise ValueError(f"fused_block supports 1 <= C <= {MAX_C}, got C={c}")
    if dtype == torch.float32:
        cs = (c + 3) & ~3
        return LaunchPlan(16, c, -(-npix // 16), 4 * (2 * 16 * cs + 16 * 64 + 64 * 65), 4)
    if dtype != torch.bfloat16:
        raise TypeError(f"fused_block takes float32 or bfloat16 activations, got {dtype}")
    cp, mt, ncls = bf16_tiling(c)
    smem = 2 * (mt * (cp + 8) + mt * HLD + RING)
    return LaunchPlan(mt, cp, -(-npix // mt), smem, mt * ncls // 2)


def tile_weights(w1: torch.Tensor, w2: torch.Tensor, dt: torch.dtype,
                 cp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """W1 (4C, C) and W2 (C, 4C) in dt as the kernels read them: (4cp, cp)
    and (cp, 4cp), zero beyond C and 4C (no copy beyond the cast when cp =
    C), 16-byte aligned for the kernels' 16-byte copies."""
    c = w1.shape[1]
    w1c, w2c = w1.detach().to(dt), w2.detach().to(dt)
    if cp != c:
        w1p = w1c.new_zeros(4 * cp, cp)
        w1p[:4 * c, :c] = w1c
        w2p = w2c.new_zeros(cp, 4 * cp)
        w2p[:c, :4 * c] = w2c
        w1c, w2c = w1p, w2p
    w1c, w2c = w1c.contiguous(), w2c.contiguous()
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in (w1c, w2c))


def fused_block_reference(
    x: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: Optional[torch.Tensor],
    eps: float = 1e-6,
    s: Optional[torch.Tensor] = None,
    save_dwconv: bool = False,
):
    """Plain PyTorch version of the kernel, same arguments and rounding
    points. x: (B, H, W, C); dw_w: (C, 1, 7, 7); w1: (4C, C); w2: (C, 4C);
    s: (B,) f32. Returns y, or (y, d) with ``save_dwconv``."""
    dt = x.dtype
    c = x.shape[-1]
    xf = x.float()
    with fp32_precision("highest"):
        d = F.conv2d(xf.permute(0, 3, 1, 2), dw_w.float(), dw_b.float(),
                     padding=K // 2, groups=c).permute(0, 2, 3, 1)
        d = d.to(dt).float()
        mean = d.sum(-1, keepdim=True) * (1.0 / c)
        mean_sq = (d * d).sum(-1, keepdim=True) * (1.0 / c)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        xn = ((d - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(dt)
        # operands rounded to dt, products and sums in f32
        h = F.linear(xn.float(), w1.to(dt).float(), b1.float())
        h = F.gelu(h, approximate="tanh").to(dt)
        y = F.linear(h.float(), w2.to(dt).float(), b2.float())
    if gamma is not None:
        y = y * gamma.float()
    if s is not None:
        y = y * s.float().reshape(-1, 1, 1, 1)
    out = (xf + y).to(dt)
    return (out, d.to(dt)) if save_dwconv else out


def _check(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s=None) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_block takes float32 or bfloat16 activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f"fused_block wants a contiguous NHWC (B, H, W, C) tensor, got {tuple(x.shape)}")
    c = x.shape[-1]
    if not 1 <= c <= MAX_C:
        raise ValueError(f"fused_block supports 1 <= C <= {MAX_C}, got C={c}")
    shapes = {
        "dw_w": (dw_w, (c, 1, K, K)), "dw_b": (dw_b, (c,)), "ln_w": (ln_w, (c,)),
        "ln_b": (ln_b, (c,)), "w1": (w1, (4 * c, c)), "b1": (b1, (4 * c,)),
        "w2": (w2, (c, 4 * c)), "b2": (b2, (c,)),
    }
    if gamma is not None:
        shapes["gamma"] = (gamma, (c,))
    if s is not None:
        shapes["s"] = (s, (x.shape[0],))
    for name, (t, want) in shapes.items():
        if t is None and name == "dw_b":  # the backward takes no dwconv bias
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"fused_block: {name} has shape {tuple(t.shape)}, want {want}")
        if t.device != x.device:
            raise ValueError(f"fused_block: {name} is on {t.device}, x on {x.device}")


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library, built with ``defines`` (-D macros; the package
    uses none, scripts/ablate_fused_block_torch.py switches parts off)."""
    lib = _build.load("fused_block", defines)
    fn = lib.fused_block_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        lib.fused_block_plan_smem.argtypes = [ctypes.c_int] * 4
        lib.fused_block_plan_smem.restype = ctypes.c_longlong
    return lib


def fused_block(
    x: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: Optional[torch.Tensor],
    eps: float = 1e-6,
    s: Optional[torch.Tensor] = None,
    save_dwconv: bool = False,
):
    """One ConvNeXt block on NHWC ``x``; weights in the reference layouts.
    With ``s`` (B,) the branch is scaled per sample; with ``save_dwconv``
    the call returns (y, d). It calls the custom op ``fused_block`` (serving
    mode) or ``fused_block_save`` (either argument given): CUDA tensors
    launch the kernel (``fused_block.launches`` counts each launch); CPU
    tensors run the plain version."""
    _check(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block runs on cuda or cpu tensors, got {x.device}")
    if s is None and not save_dwconv:
        return _serving_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, float(eps))
    if s is None:  # the kernel's save mode takes a scale: ones
        s = torch.ones(x.shape[0], device=x.device)
    y, d = _save_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, float(eps), s)
    return (y, d) if save_dwconv else y


# The kernel as two torch.library custom ops, so that a traced program
# (torch.export, torch.compile) sees one node per block. The CPU
# implementation is the plain version; the CUDA one chooses the launch plan,
# tiles the weights and launches the kernel, all at run time, never traced.
OPS = "audioset_convnext_inf_torch"  # namespace of the port's custom ops
_ARGS = ("Tensor x, Tensor dw_w, Tensor dw_b, Tensor ln_w, Tensor ln_b, Tensor w1, "
         "Tensor b1, Tensor w2, Tensor b2, Tensor? gamma, float eps")


@torch.library.custom_op(f"{OPS}::fused_block", mutates_args=(), device_types="cpu",
                         schema=f"({_ARGS}) -> Tensor")
def _serving_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps):
    return fused_block_reference(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)


@_serving_op.register_kernel("cuda")
def _serving_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps):
    b, h, w, c = x.shape
    return _forward_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, None, False,
                         launch_plan(c, x.dtype, b * h * w))


@_serving_op.register_fake
def _serving_fake(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps):
    return torch.empty_like(x)


@torch.library.custom_op(f"{OPS}::fused_block_save", mutates_args=(), device_types="cpu",
                         schema=f"({_ARGS}, Tensor s) -> (Tensor, Tensor)")
def _save_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s):
    return fused_block_reference(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, True)


@_save_op.register_kernel("cuda")
def _save_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s):
    b, h, w, c = x.shape
    return _forward_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, True,
                         launch_plan(c, x.dtype, b * h * w))


@_save_op.register_fake
def _save_fake(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s):
    return torch.empty_like(x), torch.empty_like(x)


def _forward_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, save: bool,
                  plan: LaunchPlan, defines: Tuple[str, ...] = ()):
    """One launch of the kernel under ``plan`` (checked arguments, CUDA x),
    from the library built with ``defines``: serving mode (``s`` None) ->
    y, or save mode (``s`` (B,) given) -> (y, d)."""
    if save == (s is None):
        raise ValueError("the kernel's save mode takes s, and serving mode none")
    lib = _lib(defines)
    b, h, w, c = x.shape
    dt = x.dtype

    def f32(t):
        return t.detach().to(torch.float32).contiguous()

    dww = f32(dw_w).reshape(c, K * K).t().contiguous()  # (49, C), tap-major
    args = (f32(dw_b), f32(ln_w), f32(ln_b))
    w1c, w2c = tile_weights(w1, w2, dt, plan.cp)
    b1c, b2c = f32(b1), f32(b2)
    g = f32(gamma) if gamma is not None else None
    out = torch.empty_like(x)
    sc = f32(s) if save else None
    d = torch.empty_like(x) if save else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_block_forward(
            x.data_ptr(), out.data_ptr(), dww.data_ptr(), *(t.data_ptr() for t in args),
            w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(),
            g.data_ptr() if g is not None else None,
            sc.data_ptr() if save else None, d.data_ptr() if save else None,
            b, h, w, c, float(eps), _DTYPE_CODE[dt], stream, plan.mt, plan.cp)
    if err != 0:
        raise RuntimeError(f"fused_block kernel launch failed: cudaError {err}")
    fused_block.launches += 1
    fused_block.save_launches += int(save)
    return (out, d) if save else out


fused_block.launches = 0  # every launch
fused_block.save_launches = 0  # the launches in save mode (of those counted above)
