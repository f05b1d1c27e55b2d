"""Public wrapper of the fused RMSNorm kernel.

Counterpart of ``repro.kernels.rmsnorm.ops.rms_norm``, with one difference:
the reference op drops its ``eps`` (``del eps``) and always uses 1e-6; this
one honours it, as ``repro.models.layers.rms_norm`` does. At the default
1e-6 the two agree. Inputs are checked; then

* a CPU tensor takes the plain version (:mod:`.ref`);
* a CUDA tensor launches the hand-written kernel (``csrc/rmsnorm.cu``) on
  the current stream, or raises. There is no fallback: a build failure, a
  refused launch or an unsupported input is an error.

x and scale may each be float32 or bfloat16 (any pair, no cast); the
output has x's dtype and shape. Leading dimensions are flattened into rows;
a non-contiguous x is copied to contiguous rows first. The kernel has no
backward yet: on the card, a call that autograd would differentiate raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import ref

LAUNCHES = 0

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: dict = {}


def _kernel(x_dtype: torch.dtype, scale_dtype: torch.dtype):
    name = f"rmsnorm_{_NAMES[x_dtype]}_{_NAMES[scale_dtype]}"
    if name not in _fns:
        fn = getattr(_build.load_library("rmsnorm"), name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
        fn.argtypes += [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


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


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    global LAUNCHES
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise NotImplementedError(
            "the RMSNorm kernel has no backward yet (ROADMAP Queue 1 #14): call it without grad"
        )
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype not in _NAMES:
            raise TypeError(f"the RMSNorm kernel takes float32 or bfloat16 {name}, got {t.dtype}")
    d = x.shape[-1]
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    fn = _kernel(x.dtype, scale.dtype)
    err = _build.call(fn, x.device, x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, eps)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) → ``x · rsqrt(mean(x²) + eps) · scale`` per
    row in x's dtype (f32 arithmetic, the mean over the true d)."""
    _check(x, scale)
    if x.device.type == "cpu":
        return ref.rms_norm(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no RMSNorm route for device {x.device}")
    return _launch(x, scale, float(eps))
