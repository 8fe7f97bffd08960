"""Fused RFM affinity attention: the Hopper kernels, their plain versions
and the ``autograd.Function`` that joins them.

    out[n, j, c] = Σ_i softmax_i(q[n, i]·k[n, j]) · v[n, i, c]

The softmax runs over the first index i (column-normalised affinity) and
there is no 1/√D scale.  Two kernels, both IEEE float32 and both keeping
the L×L affinity out of device memory:

* the forward (``csrc/rfm_attention.cu``) replaces
  ``pistoseg_tpu/ops/pallas/rfm_attention.py::_kernel`` /
  ``_rfm_attention_pallas``: a flash-style walk over i with an online
  softmax per output column; it can also write the per-column
  log-sum-exp ``lse`` that the backward needs;
* the backward (``csrc/rfm_attention_bwd.cu``) replaces ``_rfm_bwd``,
  the JAX package's XLA recompute: two passes that recompute the
  affinity tile by tile from ``lse`` and sum dq, dv and dk without atomics.

The sources state their bounds and designs.  ``rfm_attention`` is
differentiable: when an input requires grad it runs through
``RFMAttention``, whose backward launches the backward kernel.  CPU
tensors take the plain versions in both directions; CUDA tensors launch
the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pistoseg_tpu_torch.ops.cuda import build

_FWD_SOURCE = "rfm_attention"
_BWD_SOURCE = "rfm_attention_bwd"


def rfm_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: materialises the (N, L, L) affinity, in f32."""
    s = torch.einsum("nid,njd->nij", q.float(), k.float())
    p = torch.softmax(s, dim=1)
    return torch.einsum("nij,nic->njc", p, v.float())


def rfm_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, line for line the JAX package's
    ``_rfm_bwd``: recompute P = softmax_i(q·k), then dv, dP, dS, dq, dk.
    Materialises (N, L, L) tensors, in f32."""
    q, k, v, g = (t.float() for t in (q, k, v, g))
    s = torch.einsum("nid,njd->nij", q, k)
    p = torch.softmax(s, dim=1)                         # (N, i, j)
    # out[j, c] = Σ_i p[i, j] v[i, c]
    dv = torch.einsum("nij,njc->nic", p, g)
    dp = torch.einsum("nic,njc->nij", v, g)
    # softmax over axis 1 (i): ds = p * (dp − Σ_i p·dp)
    ds = p * (dp - torch.sum(p * dp, dim=1, keepdim=True))
    dq = torch.einsum("nij,njd->nid", ds, k)
    dk = torch.einsum("nij,nid->njd", ds, q)
    return dq, dk, dv


def _forward_library() -> ctypes.CDLL:
    lib = build.load(_FWD_SOURCE)
    fn = lib.rfm_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rfm_attention_max_c.restype = ctypes.c_int
    lib.rfm_attention_max_d.restype = ctypes.c_int
    return lib


def _backward_library() -> ctypes.CDLL:
    lib = build.load(_BWD_SOURCE)
    fn = lib.rfm_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rfm_attention_bwd_max_c.restype = ctypes.c_int
    lib.rfm_attention_bwd_max_d.restype = ctypes.c_int
    return lib


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **more: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{what}: {name} must be (N, L, ·), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
    if q.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} != k {tuple(k.shape)}")
    if v.shape[:2] != q.shape[:2]:
        raise ValueError(f"{what}: v {tuple(v.shape)} does not match q "
                         f"{tuple(q.shape)} on (N, L)")
    for name, t in more.items():
        if t.shape != v.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != v {tuple(v.shape)}")


def _check_kernel_shapes(what: str, q: torch.Tensor, c: int, max_d: int,
                         max_c: int) -> None:
    d = q.shape[2]
    if d % 4 or d > max_d:
        raise ValueError(f"{what}: D={d} must be a multiple of 4 and <= {max_d}")
    if c > max_c:
        raise ValueError(f"{what}: C={c} > {max_c}")


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if q.device.type != "cuda":
        raise ValueError(f"rfm_attention: unsupported device {q.device}")
    lib = _forward_library()
    n, l, _ = q.shape
    c = v.shape[2]
    _check_kernel_shapes("rfm_attention", q, c, lib.rfm_attention_max_d(),
                         lib.rfm_attention_max_c())
    if q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("rfm_attention: q and k must be 16-byte aligned")
    out = torch.empty_like(v)
    lse = torch.empty(n, l, device=q.device, dtype=torch.float32) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rfm_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(),
                                    None if lse is None else lse.data_ptr(),
                                    n, l, q.shape[2], c, stream)
    if err != 0:
        raise RuntimeError(f"rfm_attention kernel launch failed: cudaError {err}")
    rfm_attention.launches += 1
    return out, lse


def rfm_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: Optional[torch.Tensor],
        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``rfm_attention`` for the upstream gradient ``g``.

    ``out`` and ``lse`` (N, L) are the forward's.  CPU tensors take the
    plain version, which recomputes from q, k, v and g alone; CUDA tensors
    launch the backward kernel (counted in
    ``rfm_attention_backward.launches``)."""
    _check("rfm_attention_backward", q, k, v, out=out, g=g)
    if q.device.type == "cpu":
        return rfm_attention_backward_reference(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError(f"rfm_attention_backward: unsupported device {q.device}")
    lib = _backward_library()
    n, l, d = q.shape
    c = v.shape[2]
    _check_kernel_shapes("rfm_attention_backward", q, c, lib.rfm_attention_bwd_max_d(),
                         lib.rfm_attention_bwd_max_c())
    if (lse is None or lse.shape != (n, l) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("rfm_attention_backward: lse must be a contiguous float32 "
                         f"(N, L) = {(n, l)} tensor on {q.device}")
    if q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("rfm_attention_backward: q and k must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rfm_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, l, d, c, stream)
    if err != 0:
        raise RuntimeError(f"rfm_attention_backward kernel launch failed: cudaError {err}")
    rfm_attention_backward.launches += 1
    return dq, dk, dv


class RFMAttention(torch.autograd.Function):
    """The differentiable attention: forward kernel (with ``lse``), then
    the backward kernel; the plain versions for CPU tensors.  Counterpart
    of the JAX package's custom VJP ``_rfm_attention_diff``."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out, lse = rfm_attention_reference(q, k, v), None
        else:
            out, lse = _launch_forward(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return rfm_attention_backward(q, k, v, out, lse, g.contiguous())


def rfm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k: (N, L, D) f32; v: (N, L, C) f32 → (N, L, C) f32.

    CPU tensors take the plain version; CUDA tensors launch the forward
    kernel (counted in ``rfm_attention.launches``).  Differentiable: with
    grad enabled and an input that requires it, the call goes through
    ``RFMAttention``."""
    _check("rfm_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return RFMAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return rfm_attention_reference(q, k, v)
    return _launch_forward(q, k, v, with_lse=False)[0]


rfm_attention.launches = 0
rfm_attention_backward.launches = 0
