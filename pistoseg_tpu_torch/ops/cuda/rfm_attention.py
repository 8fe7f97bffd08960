"""Fused RFM affinity attention: the Hopper kernel and its plain version.

    out[n, j, c] = Σ_i softmax_i(q[n, i]·k[n, j]) · v[n, i, c]

The softmax runs over the first index i (column-normalised affinity) and
there is no 1/√D scale.  The kernel (``csrc/rfm_attention.cu``) replaces
``pistoseg_tpu/ops/pallas/rfm_attention.py::_kernel`` /
``_rfm_attention_pallas``: a flash-style walk over i with an online
softmax per output column, in IEEE float32, that never writes the L×L
affinity to device memory.  The source states its bound and design.

A tensor on the CPU goes to ``rfm_attention_reference``; a CUDA tensor
goes to the kernel or raises.  Forward only: the ``autograd.Function``
with a backward kernel comes with the stage-4 training slice.
"""

from __future__ import annotations

import ctypes

import torch

from pistoseg_tpu_torch.ops.cuda import build

_SOURCE = "rfm_attention"


def rfm_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: materialises the (N, L, L) affinity, in f32."""
    s = torch.einsum("nid,njd->nij", q.float(), k.float())
    p = torch.softmax(s, dim=1)
    return torch.einsum("nij,nic->njc", p, v.float())


def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.rfm_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rfm_attention_max_c.restype = ctypes.c_int
    lib.rfm_attention_max_d.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"rfm_attention: {name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"rfm_attention: {name} must be (N, L, ·), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"rfm_attention: {name} must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                "rfm_attention is forward-only: an input requires grad")
        if t.device != q.device:
            raise ValueError(f"rfm_attention: {name} on {t.device}, q on {q.device}")
    if q.shape != k.shape:
        raise ValueError(f"rfm_attention: q {tuple(q.shape)} != k {tuple(k.shape)}")
    if v.shape[:2] != q.shape[:2]:
        raise ValueError(f"rfm_attention: v {tuple(v.shape)} does not match q "
                         f"{tuple(q.shape)} on (N, L)")


def rfm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k: (N, L, D) f32; v: (N, L, C) f32 → (N, L, C) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``rfm_attention.launches``)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return rfm_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"rfm_attention: unsupported device {q.device}")
    lib = _library()
    n, l, d = q.shape
    c = v.shape[2]
    if d % 4 or d > lib.rfm_attention_max_d():
        raise ValueError(f"rfm_attention: D={d} must be a multiple of 4 and "
                         f"<= {lib.rfm_attention_max_d()}")
    if c > lib.rfm_attention_max_c():
        raise ValueError(f"rfm_attention: C={c} > {lib.rfm_attention_max_c()}")
    if q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("rfm_attention: q and k must be 16-byte aligned")
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rfm_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), n, l, d, c, stream)
    if err != 0:
        raise RuntimeError(f"rfm_attention kernel launch failed: cudaError {err}")
    rfm_attention.launches += 1
    return out


rfm_attention.launches = 0
