"""Public wrapper of the fused RMSNorm kernel.

Counterpart of ``repro.kernels.rmsnorm.ops.rms_norm``, with one difference:
the reference op drops its ``eps`` (``del eps``) and always uses 1e-6; this
one honours it, as ``repro.models.layers.rms_norm`` does. At the default
1e-6 the two agree.

* a CPU tensor is checked and takes the plain version (:mod:`.ref`);
* a CUDA tensor launches the hand-written kernel (``csrc/rmsnorm.cu``) on
  the current stream, or raises. There is no fallback: a build failure, a
  refused launch or an unsupported input is an error.

x and scale may each be float32 or bfloat16 (any pair, no cast); the
output has x's dtype and shape. Leading dimensions are flattened into rows;
a non-contiguous x is copied to contiguous rows first. On the card the
inputs are checked once per shape: the first call with a new (shape, dtype,
device) pair of x and scale, eps and alignment checks them and builds a
:class:`Plan` from :func:`launch_shape`; later calls look the plan up,
allocate the output, read the current stream and call the C entry with five
pointers (the C entry makes the plan's device current if it is not).
``LAUNCHES`` counts forward kernel launches.

Under autograd (grad enabled and x or scale requiring grad) the call goes
through :class:`RmsNormFunction`: the forward as above, and a backward
that recomputes r from x. On the card the backward is the hand-written
``rmsnorm_bwd_*`` kernel (``csrc/rmsnorm.cu``: a row pass and a
deterministic column sum for dscale), counted in ``BACKWARD_LAUNCHES``; on
the CPU both directions are the plain versions of :mod:`.ref`. A call with
grad off keeps the short host path, so serving's launches and times do not
move.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import ref

LAUNCHES = 0
BACKWARD_LAUNCHES = 0  # one a backward call: its row pass and its column sum
MAX_THREADS = 1024
MAX_BLOCKS = 1 << 16  # past this the blocks stride over the rows

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # absent from CPU builds
_fns: dict = {}
_plans: dict = {}
_bwd_plans: dict = {}
# the backward's dscale accumulator is d floats of dynamic shared memory a
# block, beside its row pass's 512 B of static reduction slots
# (red[2][2][MAX_WARPS]), within the 227 KB a block may take
MAX_BACKWARD_D = (227 * 1024 - 512) // 4


class Plan(ctypes.Structure):
    """One launch's shape and device, as the C entry reads it
    (``RmsnormPlan``)."""

    _fields_ = [
        ("rows", ctypes.c_longlong),
        ("d", ctypes.c_int),
        ("eps", ctypes.c_float),
        ("threads", ctypes.c_int),
        ("rows_per_block", ctypes.c_int),
        ("blocks", ctypes.c_int),
        ("vpt", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


class BackwardPlan(ctypes.Structure):
    """One backward launch's shape and device, as the C entry reads it
    (``RmsnormBwdPlan``)."""

    _fields_ = [
        ("rows", ctypes.c_longlong),
        ("d", ctypes.c_int),
        ("eps", ctypes.c_float),
        ("threads", ctypes.c_int),
        ("blocks", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


def _kernel(x_dtype: torch.dtype, scale_dtype: torch.dtype, prefix: str = "rmsnorm", args: int = 5):
    name = f"{prefix}_{_NAMES[x_dtype]}_{_NAMES[scale_dtype]}"
    if name not in _fns:
        fn = getattr(_build.load_library("rmsnorm"), name)
        fn.argtypes = [ctypes.c_void_p] * args
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _warps(n: int) -> int:
    """n threads rounded up to whole warps."""
    return 32 * -(-n // 32)


def launch_shape(rows: int, d: int, itemsize: int, sms: int) -> Tuple[int, int, int]:
    """(threads, rows_per_block, blocks) for ``rows`` rows of ``d``
    elements of ``itemsize`` bytes on a card with ``sms`` SMs.

    Few rows (at most two per SM): one block per row, one 16-byte vector a
    thread up to 1024 threads, so 4 rows of 3072 bf16 run as 4 blocks of 384
    threads. Many rows: two vectors a thread, and rows of at most 128
    threads packed into blocks of 256, so a narrow row gets a warp. Blocks
    stride over the rows past ``MAX_BLOCKS``."""
    slots = -(-d // (16 // itemsize))  # 16-byte vectors in an aligned row
    if rows <= 2 * sms:
        return min(MAX_THREADS, _warps(slots)), 1, rows
    per_row = min(MAX_THREADS, _warps(-(-slots // 2)))
    rows_per_block = max(1, 256 // per_row)
    return per_row * rows_per_block, rows_per_block, min(-(-rows // rows_per_block), MAX_BLOCKS)


def backward_shape(rows: int, d: int, sms: int) -> Tuple[int, int]:
    """(threads, blocks) of the backward's row pass: about four elements a
    thread of a row (whole warps, 32 to 1024), and at most two blocks an SM
    (``2 · sms``), each walking its share of the rows; the f32 dscale
    scratch then holds ``blocks`` rows of d."""
    return min(MAX_THREADS, max(32, _warps(-(-d // 4)))), max(1, min(rows, 2 * sms))


def vectors_per_thread(threads_per_row: int, d: int, itemsize: int, aligned: bool) -> int:
    """16-byte vectors of x each thread holds in registers: the fewest of 1,
    2 or 4 that cover a row's span, or 0 when even 4 do not (the kernel then
    walks the row in a loop and reads it twice). ``aligned``: x starts on a
    16-byte boundary. Unless it does and the vector's length divides d, a
    row may start off the grid and span one vector more."""
    v = 16 // itemsize
    on_grid = aligned and d % v == 0
    span = -(-(d + (0 if on_grid else v - 1)) // v)
    for vpt in (1, 2, 4):
        if threads_per_row * vpt >= span:
            return vpt
    return 0


def _plan(x: torch.Tensor, scale: torch.Tensor, eps, aligned: bool):
    """Check a new shape once; returns (entry point, plan, the plan's
    address, device index, rows)."""
    _check(x, scale)
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in _NAMES:
            raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16 {name}, got {t.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    threads, rows_per_block, blocks = launch_shape(rows, d, x.element_size(), sms)
    vpt = vectors_per_thread(threads // rows_per_block, d, x.element_size(), aligned)
    index = x.get_device()
    plan = Plan(rows, d, eps, threads, rows_per_block, blocks, vpt, index)
    return _kernel(x.dtype, scale.dtype), plan, ctypes.addressof(plan), index, rows


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    for name, t in (("x", x), ("scale", scale)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must be (..., d) with d >= 1, got shape {tuple(x.shape)}")
    if scale.shape != x.shape[-1:]:
        raise ValueError(f"scale must be ({x.shape[-1]},), got shape {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) → ``x · rsqrt(mean(x²) + eps) · scale`` per
    row in x's dtype (f32 arithmetic, the mean over the true d)."""
    global LAUNCHES
    if not (getattr(x, "is_cuda", False) and torch.is_tensor(scale)):
        _check(x, scale)
        if x.device.type != "cpu":
            raise ValueError(f"no RMSNorm route for device {x.device}")
        if (x.requires_grad or scale.requires_grad) and torch.is_grad_enabled():
            return RmsNormFunction.apply(x, scale, eps)
        return ref.rms_norm(x, scale, eps)
    # the card: this is every call's host path, kept short (see the module doc)
    if (x.requires_grad or scale.requires_grad) and torch.is_grad_enabled():
        return RmsNormFunction.apply(x, scale, eps)
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    ptr = x.data_ptr()
    aligned = ptr % 16 == 0
    key = (
        x.shape, x.dtype, x.get_device(), scale.shape, scale.dtype, scale.get_device(), eps, aligned
    )
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(x, scale, eps, aligned)
    fn, _, plan_ptr, index, rows = plan
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = fn(ptr, scale.data_ptr(), out.data_ptr(), plan_ptr, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def rms_norm_backward(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of :func:`rms_norm` at (x, scale) for the output's
    gradient ``dy`` (x's shape and dtype): dx in x's dtype, dscale in
    scale's. A CPU tensor takes the plain version
    (:func:`.ref.rms_norm_backward`); a CUDA tensor launches the backward
    kernel, or raises."""
    global BACKWARD_LAUNCHES
    _check(x, scale)
    if not torch.is_tensor(dy) or dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(
            f"dy must match x's shape {tuple(x.shape)} and dtype {x.dtype}, got "
            f"{tuple(getattr(dy, 'shape', ()))} {getattr(dy, 'dtype', type(dy).__name__)}"
        )
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.rms_norm_backward(x, scale, dy, eps)
    if not x.is_cuda:
        raise ValueError(f"no RMSNorm backward route for device {x.device}")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in _NAMES:
            raise TypeError(f"the RMSNorm backward takes float32 or bfloat16 {name}, got {t.dtype}")
    d = x.shape[-1]
    if d > MAX_BACKWARD_D:
        raise ValueError(f"the RMSNorm backward takes d <= {MAX_BACKWARD_D}, got {d}")
    x, dy, scale = x.contiguous(), dy.contiguous(), scale.contiguous()
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dx, dscale.zero_()
    key = (x.shape, x.dtype, scale.dtype, x.get_device(), eps)
    plan = _bwd_plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        threads, blocks = backward_shape(rows, d, sms)
        p = BackwardPlan(rows, d, eps, threads, blocks, x.get_device())
        fn = _kernel(x.dtype, scale.dtype, "rmsnorm_bwd", 8)
        plan = _bwd_plans[key] = (fn, p, ctypes.addressof(p), blocks)
    fn, _, plan_ptr, blocks = plan
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    err = fn(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        partial.data_ptr(), plan_ptr, _raw_stream(x.get_device()),
    )
    if err != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: cudaError_t {err}")
    BACKWARD_LAUNCHES += 1
    return dx, dscale


class RmsNormFunction(torch.autograd.Function):
    """:func:`rms_norm` with its backward: the forward kernel (or plain
    version) saving x and scale, and :func:`rms_norm_backward`, which
    recomputes r from x. Works under non-reentrant activation checkpointing
    (the recomputed forward launches again)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm(x, scale, eps)  # grad is off in here: the direct route

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward(x, scale, dy.to(x.dtype), ctx.eps)
        need_x, need_scale, _ = ctx.needs_input_grad
        return (dx if need_x else None), (dscale if need_scale else None), None
