"""The seg head's GroupNorm + ReLU on rows that are each their own sample:
the CUDA kernels of ``csrc/row_group_norm.cu`` (a forward; a backward and
its gamma/beta sum) as one autograd op, and its plain PyTorch version.

``row_group_norm_relu`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernels or raises.  The kernels take
x (M, 64) float32 in 8 groups, as the head has it.  No Pallas kernel stands
behind it: the JAX package leaves the head's norm to XLA.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import build

CHANNELS, GROUPS = 64, 8  # the head's width and groups, compiled into the kernels
_BWD_BLOCKS: dict[int, int] = {}  # device index -> the backward's resident blocks


def row_group_norm_relu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              groups: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version: ``relu(group_norm(x))``, each row of x (M, C)
    its own sample."""
    return F.relu(F.group_norm(x, groups, weight, bias, eps))


def _lib():
    lib = build.load("row_group_norm")
    if lib.row_group_norm_fwd_launch.argtypes is None:  # declare the C signatures once
        ptr, f32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
        lib.row_group_norm_fwd_launch.argtypes = [ptr, ptr, ptr, f32, i64, ptr, ptr]
        lib.row_group_norm_bwd_launch.argtypes = [ptr, ptr, ptr, ptr, f32, i64, ctypes.c_int,
                                                  ptr, ptr, ptr, ptr, ptr]
        lib.row_group_norm_bwd_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.row_group_norm_fwd_launch, lib.row_group_norm_bwd_launch,
                   lib.row_group_norm_bwd_blocks_per_sm):
            fn.restype = ctypes.c_int
    return lib


def _bwd_blocks(device: torch.device) -> int:
    """The backward's grid: every block the card holds at once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _BWD_BLOCKS:
        per_sm = ctypes.c_int(0)
        build.check_status(_lib().row_group_norm_bwd_blocks_per_sm(ctypes.byref(per_sm)),
                           "row_group_norm occupancy")
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _BWD_BLOCKS[idx] = max(1, per_sm.value) * sms
    return _BWD_BLOCKS[idx]


def _check(t: torch.Tensor, name: str, shape) -> None:
    build.check_cuda(t, f"row_group_norm_relu {name}", torch.float32, shape)
    if t.data_ptr() % 16:
        raise ValueError(f"row_group_norm_relu {name}: expected 16-byte aligned data")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class _RowGroupNormReLU(torch.autograd.Function):
    """The kernels as an autograd op; only x is saved for the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y = torch.empty_like(x)
        if x.shape[0]:
            status = _lib().row_group_norm_fwd_launch(
                x.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps, x.shape[0],
                y.data_ptr(), _stream(x))
            build.check_status(status, "row_group_norm_relu forward")
            row_group_norm_relu.launches += 1
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        rows = x.shape[0]
        if not rows:
            return torch.zeros_like(x), torch.zeros_like(weight), torch.zeros_like(bias), None
        dy = dy.contiguous()
        _check(dy, "dy", x.shape)
        dx = torch.empty_like(x)
        dweight, dbias = torch.empty_like(weight), torch.empty_like(bias)
        blocks = _bwd_blocks(x.device)
        partials = torch.empty((2, CHANNELS, blocks), dtype=x.dtype, device=x.device)
        status = _lib().row_group_norm_bwd_launch(
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), ctx.eps, rows,
            blocks, dx.data_ptr(), partials.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
            _stream(x))
        build.check_status(status, "row_group_norm_relu backward")
        row_group_norm_relu.launches += 2
        return dx, dweight, dbias, None


def row_group_norm_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        groups: int, eps: float) -> torch.Tensor:
    """``relu(group_norm(x, groups, weight, bias, eps))`` on x (M, C), each
    row normalised alone in ``groups`` groups of channels (the mean, the
    biased variance).  On the GPU one kernel launch forward and two backward
    (counted on ``row_group_norm_relu.launches``), for C = 64 in 8 groups,
    float32, contiguous; anything else raises ``ValueError`` there."""
    if x.device.type == "cpu":
        return row_group_norm_relu_plain(x, weight, bias, groups, eps)
    if groups != GROUPS or x.dim() != 2 or x.shape[1] != CHANNELS:
        raise ValueError(f"row_group_norm_relu: the kernels take x (M, {CHANNELS}) in "
                         f"{GROUPS} groups; got {tuple(x.shape)} in {groups}")
    _check(x, "x", None)
    for t, name in ((weight, "weight"), (bias, "bias")):
        _check(t, name, (CHANNELS,))
        if t.device != x.device:
            raise ValueError(f"row_group_norm_relu {name}: on {t.device}, x on {x.device}")
    return _RowGroupNormReLU.apply(x, weight, bias, float(eps))


row_group_norm_relu.launches = 0  # launches of the kernels, forward and backward
