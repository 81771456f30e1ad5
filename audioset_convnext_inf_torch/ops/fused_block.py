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

The unfused-rounding mode (``unfused_rounding=True``, bf16 only)
computes the block at the rounding points of the unfused block,
``ops/nhwc.py::convnext_block`` (the JAX package's ``_block_apply``): the
depthwise sum rounds to bf16 before its bias is added and again after, the
LN output rounds, ``h . W1^T + b1`` rounds before the GELU and again after,
``h . W2^T + b2`` rounds before the product with bf16 gamma and again
after, and the residual sum rounds; the depthwise taps enter in bf16. Its
CPU leg is ``convnext_block`` itself, on x in whatever layout it comes in.
In the save mode (the bf16 training step's stages 1-2) it also takes the
product with the bf16 drop-path scale ``s``, rounded, before the residual
sum, and saves ``dz`` (2, B, H, W, C): d as the LN reads it and z =
``h . W2^T + b2`` as gamma multiplies it, both rounded, for the fused
backward's unfused-rounding mode; x then comes contiguous, and C is at most
``UNFUSED_SAVE_MAX_C`` (the kernel is built for one and two 128-channel
output blocks).

The kernel is two ``torch.library`` custom ops, ``fused_block`` (serving)
and ``fused_block_save`` (training), each in either rounding, in the namespace
``OPS``, each with a shape ("fake") implementation, so that
``torch.export`` and ``torch.compile`` see one node per block. On a CUDA
tensor an op launches ``csrc/fused_block.cu`` (built at first use by
``ops/_build.py``) or raises; on a CPU tensor it runs
``fused_block_reference`` (``convnext_block`` in the unfused-rounding
mode), the same function in plain PyTorch. The kernel
source says what bounds it on the card and what its design does about it.
``launch_plan`` chooses the launch (pixel tiles and their clusters, channel
padding of the bf16 tiles, output slices, hidden ranges, ring stages,
shared memory) from (C, dtype, pixel count) alone; the wrapper passes it
to the kernel, which refuses a plan it cannot run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from audioset_convnext_inf_torch.ops import _build
from audioset_convnext_inf_torch.ops.nhwc import convnext_block
from audioset_convnext_inf_torch.ops.precision import fp32_precision
from audioset_convnext_inf_torch.utils.profiling import span

K = 7
MAX_C = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

CPAD = 128  # the bf16 kernels pad C to a multiple of this for their weight tiles
UNFUSED_SAVE_MAX_C = 256  # widest C of the unfused-rounding save mode (NB = 1, 2)

# The bf16 kernel's plan, as csrc/fused_block.cu's bf16_plan sets it (the
# kernel refuses any other plan).
MT = 64  # pixels of a tile: one consumer warpgroup's rows
NH = 128  # hidden units of a chunk
CLUSTER = 2  # pixel tiles of a cluster: each weight box is fetched once for both
SMS = 132  # an H100's SMs: the hidden split aims at half of them or more
THREADS = 384  # two consumer warpgroups and the producer's
CONSUMER_REGS = 232  # setmaxnreg: a consumer thread's registers (the producer's keep 40)
PRODUCER_REGS = 40
NARROW_CONSUMER_REGS = 104  # NB = 1: two blocks an SM, 80 registers a thread at launch
NARROW_PRODUCER_REGS = 32  # NB = 1: what the producer keeps, so that the consumers get 104
H_REGS = 32  # f32 registers of a warpgroup's (64, 64) share of a chunk's h
BOX_BYTES = 128 * 64 * 2  # a 128-row x 64 box of W1 or W2 (bf16)
XBOX_BYTES = MT * 64 * 2  # a 64 x 64 box of xn or h
HT_BYTES = 2 * (NH // 64) * XBOX_BYTES  # two h tiles; x's staging for the stencil before
MAX_SMEM = 232_448  # shared memory one block may opt into on an H100
SM_SMEM = 233_472  # shared memory of an H100 SM; each resident block takes 1 KB more
NARROW_SMEM = SM_SMEM // 2 - 1024  # a block's share when two share an SM, static included
STATIC_RESERVE = 2048  # static shared memory the kernel may take beside the dynamic
STAGE_CAP = 12  # most slots of the weight ring (one box each)


def padded_c(c: int) -> int:
    """C padded to CPAD: the channels the bf16 kernels' tiles see."""
    return -(-c // CPAD) * CPAD


def unfused_save_fits(c: int) -> bool:
    """Whether the unfused-rounding save mode takes C channels."""
    return 1 <= c <= UNFUSED_SAVE_MAX_C


class LaunchPlan(NamedTuple):
    mt: int           # output pixels per thread block (per tile)
    cp: int           # channels as the kernel's tiles see them (bf16: padded to CPAD)
    ctas: int         # thread blocks of the main launch
    smem_bytes: int   # dynamic shared memory of one block
    acc_regs: int     # f32 registers per consumer thread that hold its share of the sum
    out_blocks: int = 1     # bf16: 128-channel blocks of a block's output slice (NB)
    out_split: int = 1      # output slices of NB * 128 channels (each recomputes h)
    hidden_split: int = 1   # ranges of the hidden chunks, added in range order
    per: int = 0            # bf16: 128-unit hidden chunks per range
    stages: int = 0         # bf16: slots of the weight ring, one 128 x 64 box each
    tiles: int = 0          # bf16: pixel tiles, rounded up to whole clusters
    threads: int = 256      # threads of a block
    l2_weight_bytes: int = 0  # bf16: weight bytes the call reads from L2 (one fetch per cluster)
    launches: Tuple[Tuple[str, int], ...] = ()  # (kernel, blocks) of one call
    chunks: int = 0         # bf16: 128-unit chunks that hold real hidden units, ceil(4C / 128)
    sm_blocks: int = 1      # bf16: blocks an SM holds at once (2 at NB = 1)


def launch_plan(c: int, dtype: torch.dtype, npix: int, split: Optional[int] = None) -> LaunchPlan:
    """The forward kernel's launch for C channels and npix = B*H*W pixels.
    bf16: 64-pixel tiles in clusters of two that share every weight box
    (128 pixel rows per box read from L2), output slices of 384 channels up
    to C = 768 and 512 above (below CP = 384 one slice of CP channels, so
    the second product runs no channel that does not exist), the chunks of
    128 hidden units that hold real ones (ceil(4C / 128)), two blocks an
    SM at CP = 128 (the ring in half an SM's shared memory), and the 4C
    hidden units in ranges where the
    tiles and slices alone would keep under half of the card's SMs busy
    (``split`` forces the number of ranges: the ablation script's
    ``K1_SPLIT`` build). f32: the FMA kernel, 16 pixels per block, the (16,
    C) sum in shared memory."""
    if not 1 <= c <= MAX_C:
        raise ValueError(f"fused_block supports 1 <= C <= {MAX_C}, got C={c}")
    if dtype == torch.float32:
        cs = (c + 3) & ~3
        ctas = -(-npix // 16)
        return LaunchPlan(16, c, ctas, 4 * (2 * 16 * cs + 16 * 64 + 64 * 65), 4,
                          launches=(("fused_block_f32_kernel", ctas),))
    if dtype != torch.bfloat16:
        raise TypeError(f"fused_block takes float32 or bfloat16 activations, got {dtype}")
    cp = padded_c(c)
    nb = cp // 128 if cp < 384 else 3 if cp <= 768 else 4
    out_split = -(-cp // (128 * nb))
    tiles = -(-npix // MT)
    tiles += tiles % CLUSTER
    chunks = -(-4 * c // NH)
    base = tiles * out_split
    want = 1
    if split:
        want = min(split, chunks)
    elif 0 < base < SMS // 2:
        want = min(chunks, SMS // base)
    per = -(-chunks // want)
    hidden_split = -(-chunks // per)
    fixed = 1024 + MT * cp * 2 + HT_BYTES  # + 1024: the kernel aligns its tiles to 1024 bytes
    sm_blocks = 2 if nb == 1 else 1
    budget = (NARROW_SMEM if sm_blocks == 2 else MAX_SMEM) - STATIC_RESERVE
    stages = min(STAGE_CAP, (budget - fixed) // BOX_BYTES)
    ctas = tiles * out_split * hidden_split
    # per cluster and range: W1's rows of the range once for each slice, W2's
    # rows of the slice (inside cp) once
    l2 = tiles // CLUSTER * 2 * NH * cp * chunks * (out_split + 1)
    launches = (("fused_block_wgmma_kernel", ctas),)
    if hidden_split > 1:
        launches += (("fused_block_sum_kernel", -(-npix * c // 256)),)
    return LaunchPlan(MT, cp, ctas, fixed + stages * BOX_BYTES, 32 * nb, nb, out_split,
                      hidden_split, per, stages, tiles, THREADS, l2, launches, chunks, sm_blocks)


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


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as both kernels read an f32 parameter: detached, f32 and
    contiguous, with no copy where it is f32 and contiguous already."""
    return t.detach().to(torch.float32).contiguous()


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


def _check(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s=None,
           any_layout: bool = False) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_block takes float32 or bfloat16 activations, got {x.dtype}")
    if x.dim() != 4 or not (any_layout or x.is_contiguous()):
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
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        lib.fused_block_plan_smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [
            ctypes.c_int] * 6
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
    unfused_rounding: bool = False,
):
    """One ConvNeXt block on NHWC ``x``; weights in the reference layouts.
    With ``s`` (B,) the branch is scaled per sample; with ``save_dwconv``
    the call returns (y, d). With ``unfused_rounding`` (bf16) the block
    rounds where the unfused block does; in serving mode x may come in any
    layout, and with ``save_dwconv`` the call returns (y, dz), dz = d and
    z stacked (see the module docstring). It calls the custom op
    ``fused_block`` (serving mode) or ``fused_block_save`` (``s`` or
    ``save_dwconv`` given), either in either rounding: CUDA tensors launch
    the kernel (``fused_block.launches`` counts each launch); CPU tensors
    run the plain version."""
    save = s is not None or save_dwconv
    _check(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s,
           any_layout=unfused_rounding and not save)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block runs on cuda or cpu tensors, got {x.device}")
    if unfused_rounding:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"fused_block: the unfused-rounding mode takes bfloat16 "
                            f"activations, got {x.dtype}")
        if save and not unfused_save_fits(x.shape[-1]):
            raise ValueError(f"fused_block: the unfused-rounding save mode takes C <= "
                             f"{UNFUSED_SAVE_MAX_C}, got C={x.shape[-1]}")
    # the flag is passed only when set, so a traced program of the default
    # modes reads as it did before there was one
    flag = (True,) if unfused_rounding else ()
    if not save:
        return _serving_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, float(eps), *flag)
    if s is None:  # the kernel's save mode takes a scale: ones
        s = torch.ones(x.shape[0], device=x.device)
    y, d = _save_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, float(eps), s, *flag)
    return (y, d) if save_dwconv else y


# The kernel as two torch.library custom ops, so that a traced program
# (torch.export, torch.compile) sees one node per block. The CPU
# implementation is the plain version; the CUDA one chooses the launch plan,
# tiles the weights and launches the kernel, all at run time, never traced.
OPS = "audioset_convnext_inf_torch"  # namespace of the port's custom ops
_ARGS = ("Tensor x, Tensor dw_w, Tensor dw_b, Tensor ln_w, Tensor ln_b, Tensor w1, "
         "Tensor b1, Tensor w2, Tensor b2, Tensor? gamma, float eps")


@torch.library.custom_op(f"{OPS}::fused_block", mutates_args=(), device_types="cpu",
                         schema=f"({_ARGS}, bool unfused_rounding=False) -> Tensor")
def _serving_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, unfused_rounding=False):
    if unfused_rounding:
        return convnext_block(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    return fused_block_reference(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)


@_serving_op.register_kernel("cuda")
def _serving_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, unfused_rounding=False):
    x = x.contiguous()  # the unfused-rounding mode takes any layout
    b, h, w, c = x.shape
    return _forward_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, None, False,
                         launch_plan(c, x.dtype, b * h * w), unfused=unfused_rounding)


@_serving_op.register_fake
def _serving_fake(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, unfused_rounding=False):
    # the CPU leg keeps x's layout (convnext_block's ops follow it), the
    # kernel writes NHWC
    return torch.empty_like(x) if x.device.type == "cpu" else x.new_empty(x.shape)


@torch.library.custom_op(f"{OPS}::fused_block_save", mutates_args=(), device_types="cpu",
                         schema=f"({_ARGS}, Tensor s, bool unfused_rounding=False) "
                                "-> (Tensor, Tensor)")
def _save_op(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, unfused_rounding=False):
    if unfused_rounding:
        y, d, z = convnext_block(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps,
                                 drop_scale=s, saves=True)
        return y, torch.stack((d, z))
    return fused_block_reference(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, True)


@_save_op.register_kernel("cuda")
def _save_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, unfused_rounding=False):
    b, h, w, c = x.shape
    return _forward_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, True,
                         launch_plan(c, x.dtype, b * h * w), unfused=unfused_rounding)


@_save_op.register_fake
def _save_fake(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, unfused_rounding=False):
    d = x.new_empty((2, *x.shape)) if unfused_rounding else torch.empty_like(x)
    return torch.empty_like(x), d


def _forward_cuda(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, s, save: bool,
                  plan: LaunchPlan, defines: Tuple[str, ...] = (), unfused: bool = False):
    """One launch of the kernel under ``plan`` (checked arguments, CUDA x),
    from the library built with ``defines``: serving mode (``s`` None) ->
    y, or save mode (``s`` (B,) given) -> (y, d); ``unfused``: either mode
    at the unfused block's rounding points (bf16), the save mode's d then
    (2, B, H, W, C), d and z."""
    if save == (s is None):
        raise ValueError("the kernel's save mode takes s, and serving mode none")
    if unfused and (x.dtype != torch.bfloat16 or save and plan.out_blocks > 2):
        raise ValueError("the kernel's unfused-rounding mode is bf16 only, and its save mode "
                         "takes one or two 128-channel output blocks")
    lib = _lib(defines)
    b, h, w, c = x.shape
    dt = x.dtype

    def taps(t):  # the unfused block's depthwise taps, gamma and s enter in bf16
        return _f32(t.detach().to(dt) if unfused else t)

    with span("fused_block.prep"):
        dww = taps(dw_w).reshape(c, K * K).t().contiguous()  # (49, C), tap-major
        args = (_f32(dw_b), _f32(ln_w), _f32(ln_b))
        w1c, w2c = tile_weights(w1, w2, dt, plan.cp)
        b1c, b2c = _f32(b1), _f32(b2)
        g = taps(gamma) if gamma is not None else None
        out = torch.empty_like(x)
        sc = taps(s) if save else None
        d = (x.new_empty((2, *x.shape)) if unfused else torch.empty_like(x)) if save else None
        part = (torch.empty(plan.hidden_split, b * h * w, plan.cp, device=x.device)
                if dt == torch.bfloat16 and plan.hidden_split > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_block_forward(
            x.data_ptr(), out.data_ptr(), dww.data_ptr(), *(t.data_ptr() for t in args),
            w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(),
            g.data_ptr() if g is not None else None,
            sc.data_ptr() if save else None, d.data_ptr() if save else None,
            b, h, w, c, float(eps), _DTYPE_CODE[dt], stream, plan.mt, plan.cp, plan.out_split,
            plan.hidden_split, plan.per, plan.stages, part.data_ptr() if part is not None else None,
            int(unfused))
    if err != 0:
        raise RuntimeError(f"fused_block kernel launch failed: cudaError {err}")
    fused_block.launches += 1
    fused_block.save_launches += int(save)
    fused_block.unfused_rounding_launches += int(unfused and not save)
    fused_block.unfused_rounding_save_launches += int(unfused and save)
    return (out, d) if save else out


fused_block.launches = 0  # every launch
fused_block.save_launches = 0  # the launches in save mode (of those counted above)
fused_block.unfused_rounding_launches = 0  # serving launches in the unfused-rounding mode
fused_block.unfused_rounding_save_launches = 0  # save-mode launches in that mode
