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
``rmsnorm_bwd_*`` kernel (``csrc/rmsnorm.cu``: a row pass with each row in
registers and each thread's dscale terms summed in registers, then a
deterministic column sum over one partial row a block), counted once a
call in ``BACKWARD_LAUNCHES``; on the CPU both directions are the plain
versions of :mod:`.ref`. Its host path is the forward's: the inputs are
checked once per (shapes, dtypes, devices, eps) key, which caches the
:class:`BackwardPlan` built from :func:`backward_plan`; later calls
allocate dx, dscale and the scratch and call the C entry. A call with grad
off keeps the short host path, so serving's launches and times do not move.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, _costs
from repro_torch.kernels.rmsnorm import ref

LAUNCHES = 0
BACKWARD_LAUNCHES = 0  # one a backward call: its row pass and its column sum
MAX_THREADS = 1024
MAX_BLOCKS = 1 << 16  # past this the blocks stride over the rows
# the backward (csrc/rmsnorm.cu): a row of at most BWD_MAX_SLOTS 16-byte
# slots stays in registers (1024 threads of one slot, or 256 of four: see
# bwd_max_threads there); groups of several warps take named barriers 1..15
# (BWD_MAX_BARRIER_GROUPS), so at most 15 of them a block
BWD_MAX_SLOTS = 1024
BWD_MAX_BARRIER_GROUPS = 15

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # absent from CPU builds
_fns: dict = {}
_plans: dict = {}
_bwd_plans: dict = {}


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
        ("rows_per_block", ctypes.c_longlong),
        ("d", ctypes.c_int),
        ("eps", ctypes.c_float),
        ("vpt", ctypes.c_int),
        ("group_threads", ctypes.c_int),
        ("groups", ctypes.c_int),
        ("blocks", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


class BackwardSplit(NamedTuple):
    """How the backward kernel splits ``rows`` rows of d: blocks of
    ``groups`` row groups of ``group_threads`` threads, thread t of a
    group holding slots t, t + group_threads, ... (``vpt`` of them; 0: the
    loop route, which walks them), block b taking rows [b R, b R + R) of
    R = ``rows_per_block`` and its groups interleaving over them; then the
    column sum, ``sum_warps`` warps to 32 columns, launched as a
    programmatic dependent of the row pass."""

    vpt: int
    group_threads: int
    groups: int
    blocks: int
    rows_per_block: int

    @property
    def threads(self) -> int:
        return self.group_threads * self.groups

    @property
    def sum_warps(self) -> int:
        """The column sum's warps a block: a warp a partial row, up to 32."""
        return min(32, self.blocks)

    def group_rows(self, rows: int, block: int, group: int) -> range:
        """The rows group ``group`` of block ``block`` walks, in order."""
        start = block * self.rows_per_block
        return range(start + group, min(rows, start + self.rows_per_block), self.groups)

    def thread_slots(self, slots: int, t: int) -> list:
        """The 16-byte slots (elements [k V, k V + V)) thread t of a group
        holds, in order."""
        if self.vpt == 0:
            return list(range(t, slots, self.group_threads))
        return [k for k in (t + j * self.group_threads for j in range(self.vpt)) if k < slots]

    def combine_levels(self) -> list:
        """The block's tree over its groups' dscale sums: per level, the
        (group, partner) pairs, the partner's sum added into the group's."""
        levels, n = [], self.groups
        while n > 1:
            h = -(-n // 2)
            levels.append([(q, q + h) for q in range(n - h)])
            n = h
        return levels

    def sum_tree(self, rows: int) -> list:
        """Every column's dscale in summation order: for each warp w of the
        column sum (added in warp order), the partial rows w, w + W, ...
        it adds in order, each partial row its block's tree over its
        groups, each group's leaf its rows in the order it walks them."""

        def block_tree(b):
            sums = {g: list(self.group_rows(rows, b, g)) for g in range(self.groups)}
            for level in self.combine_levels():
                for g, partner in level:
                    sums[g] = [sums[g], sums[partner]]
            return sums[0]

        return [
            [block_tree(b) for b in range(w, self.blocks, self.sum_warps)]
            for w in range(self.sum_warps)
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


def backward_max_threads(vpt: int) -> int:
    """The most threads a backward row-pass block may take at ``vpt``
    slots a thread (0: the loop route): the kernel's ``__launch_bounds__``,
    under which its registers (x and dy of this row and the next, the
    scales and dscale sums, all in f32) fit the SM."""
    return MAX_THREADS if vpt <= 1 else MAX_THREADS // vpt


def backward_plan(
    rows: int,
    d: int,
    itemsize: int,
    sms: int,
    vpt: int = None,
    groups: int = None,
    blocks_per_sm: int = 1,
) -> BackwardSplit:
    """The backward's split of ``rows`` rows of ``d`` elements of
    ``itemsize`` bytes on a card with ``sms`` SMs.

    A row of at most ``BWD_MAX_SLOTS`` 16-byte slots stays in registers,
    by default at the most slots a thread (1, 2 or 4) that hold at most 16
    elements (its scales and dscale sums then take 32 registers) and leave
    the group a warp's worth of slots. Wider rows take the loop route, one
    group of up to 1024 threads a block. A block takes the rows it gets in
    one wave of ``blocks_per_sm`` blocks an SM (8 at 1024 rows on 132 SMs),
    in whole rounds of its groups, and there are as many blocks as those
    rows need: one partial row of dscale a block. By default a block has
    half as many groups as rows (each group's next row loads during its
    current one), all of them under 4 rows, within the block's thread
    limit and 15 groups of several warps. ``vpt``, ``groups`` and
    ``blocks_per_sm`` other than the defaults give the ``[plan]`` rows of
    ``chip_smoke.py``."""
    v = 16 // itemsize
    slots = -(-d // v)
    if vpt is None:  # at most 16 elements a thread, and a group of at least a warp's slots
        vpt = 0 if slots > BWD_MAX_SLOTS else max(
            n for n in (1, 2, 4) if n * v <= 16 and (n == 1 or -(-slots // n) >= 32)
        )
    if vpt == 0:
        tpr = min(MAX_THREADS, _warps(slots))
        cap = 1
    else:
        tpr = _warps(-(-slots // vpt))
        cap = backward_max_threads(vpt) // tpr
        if tpr > 32:
            cap = min(cap, BWD_MAX_BARRIER_GROUPS)
    per_block = max(1, -(-rows // (sms * blocks_per_sm)))  # rows a block in one wave
    if groups is None:  # two rows a group, so that the next row's loads overlap this one's
        groups = per_block if per_block < 4 else per_block // 2
    groups = max(1, min(cap, groups))
    per_block = groups * -(-per_block // groups)  # whole rounds of the groups
    return BackwardSplit(vpt, tpr, groups, -(-rows // per_block), per_block)


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
    if _costs.COUNTERS:  # x read, out written, scale read: no dot
        nbytes = 2 * x.numel() * x.element_size() + scale.numel() * scale.element_size()
        _costs.report("rmsnorm", 0, nbytes)
    return out


def _check_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor) -> None:
    _check(x, scale)
    if not torch.is_tensor(dy) or dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(
            f"dy must match x's shape {tuple(x.shape)} and dtype {x.dtype}, got "
            f"{tuple(getattr(dy, 'shape', ()))} {getattr(dy, 'dtype', type(dy).__name__)}"
        )
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")


def _backward_entry(x: torch.Tensor, scale: torch.Tensor, split: BackwardSplit, eps):
    """(entry point, plan, the plan's address, device index, the scratch's
    shape) of a backward launch under ``split``."""
    d = x.shape[-1]
    index = x.get_device()
    plan = BackwardPlan(
        x.numel() // d, split.rows_per_block, d, eps, split.vpt, split.group_threads, split.groups,
        split.blocks, index,
    )
    scratch = (split.blocks, -(-d // (16 // x.element_size())) * (16 // x.element_size()))
    fn = _kernel(x.dtype, scale.dtype, "rmsnorm_bwd", 8)
    return fn, plan, ctypes.addressof(plan), index, scratch


def device_backward_plan(x: torch.Tensor) -> BackwardSplit:
    """The wrapper's split for a CUDA x (..., d)."""
    d = x.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return backward_plan(x.numel() // d, d, x.element_size(), sms)


def _backward_plan(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps, split=None):
    """Check a new key once; the launch of :func:`_backward_entry` under
    ``split`` (the wrapper's by default), or None for no rows."""
    _check_backward(x, scale, dy)
    if not x.is_cuda:
        raise ValueError(f"no RMSNorm backward route for device {x.device}")
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in _NAMES:
            raise TypeError(f"the RMSNorm backward takes float32 or bfloat16 {name}, got {t.dtype}")
    if x.numel() == 0:
        return None
    return _backward_entry(x, scale, split or device_backward_plan(x), eps)


def _launch_backward(x, scale, dy, launch) -> Tuple[torch.Tensor, torch.Tensor]:
    global BACKWARD_LAUNCHES
    fn, _, plan_ptr, index, scratch = launch
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    partial = x.new_empty(scratch, dtype=torch.float32)
    err = fn(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        partial.data_ptr(), plan_ptr, _raw_stream(index),
    )
    if err != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: cudaError_t {err}")
    BACKWARD_LAUNCHES += 1
    if _costs.COUNTERS:  # x and dy read, dx written; scale read, dscale written
        nbytes = 3 * x.numel() * x.element_size() + 2 * scale.numel() * scale.element_size()
        _costs.report("rmsnorm_backward", 0, nbytes)
    return dx, dscale


def rms_norm_backward(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of :func:`rms_norm` at (x, scale) for the output's
    gradient ``dy`` (x's shape and dtype): dx in x's dtype, dscale in
    scale's. A CPU tensor takes the plain version
    (:func:`.ref.rms_norm_backward`); a CUDA tensor launches the backward
    kernel, or raises."""
    if not (getattr(x, "is_cuda", False) and torch.is_tensor(dy) and torch.is_tensor(scale)):
        _check_backward(x, scale, dy)
        if x.device.type != "cpu":
            raise ValueError(f"no RMSNorm backward route for device {x.device}")
        return ref.rms_norm_backward(x, scale, dy, eps)
    # the card: every training norm's host path, kept short (see the module doc)
    key = (
        x.shape, x.dtype, x.device, dy.shape, dy.dtype, dy.device,
        scale.shape, scale.dtype, scale.device, eps,
    )
    if key in _bwd_plans:
        launch = _bwd_plans[key]
    else:
        launch = _bwd_plans[key] = _backward_plan(x, scale, dy, eps)
    if not x.is_contiguous():
        x = x.contiguous()
    if not dy.is_contiguous():
        dy = dy.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    if launch is None:
        return torch.empty_like(x), torch.zeros_like(scale)
    return _launch_backward(x, scale, dy, launch)


def backward_launch(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, split: BackwardSplit, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel under a given split (``chip_smoke.py``'s
    ``[plan]`` rows): the inputs checked as the wrapper checks them, a plan
    built every call. Counted in ``BACKWARD_LAUNCHES``."""
    launch = _backward_plan(x, scale, dy, eps, split)
    x, dy, scale = x.contiguous(), dy.contiguous(), scale.contiguous()
    if launch is None:
        return torch.empty_like(x), torch.zeros_like(scale)
    return _launch_backward(x, scale, dy, launch)


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
