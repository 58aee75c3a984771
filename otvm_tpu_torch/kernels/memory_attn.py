"""Space-time memory read: the hand-written CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them.

The kernel (csrc/memory_attn.cu) replaces
otvm_tpu/kernels/memory_attn.py::memory_read_pallas; its source note gives
the bound on an H100 and what the simple design gives up.  It is compiled
with nvcc for sm_90a into a shared library with a plain C entry, on first
use, into build/ at the root of the checkout, and loaded with ctypes.

`memory_read` takes the plain version for tensors on the CPU and the kernel
for CUDA tensors; on CUDA it launches the kernel or raises, and never falls
back.  `launches` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

_NEG_INF = -1e30
_SRC = Path(__file__).resolve().parent / "csrc" / "memory_attn.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_KEY_DIMS = (32, 128)   # the real model and the scale=4 test model
_CV_SLICE = 128
_MAX_SLOTS = 256

launches = 0          # kernel launches since the last reset; see module doc
_lib: Optional[ctypes.CDLL] = None
build_log = ""        # nvcc's output (registers, shared memory, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the memory-read kernel cannot be built")


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"memory_attn_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)],
                                  capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    fn = lib.otvm_memory_read
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def memory_read_plain(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                      slot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """memory_read_xla in PyTorch.  q_k [B, HW, Ck]; m_k [B, T, HW, Ck];
    m_v [B, T, HW, Cv]; slot_mask [B, T] bool (True = valid) -> [B, HW, Cv]
    in q_k's dtype.  Products accumulate in fp32; p is cast to the value
    dtype before the second product, as in the reference."""
    b, t, hw, ck = m_k.shape
    cv = m_v.shape[-1]
    k = m_k.reshape(b, t * hw, ck).float()
    v = m_v.reshape(b, t * hw, cv)
    scores = torch.einsum("bqc,bkc->bqk", q_k.float(), k) / math.sqrt(ck)
    if slot_mask is not None:
        mask = slot_mask.bool().repeat_interleave(hw, dim=-1)       # [B, T*HW]
        scores = scores.masked_fill(~mask[:, None, :], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqk,bkv->bqv", p.to(v.dtype).float(), v.float())
    return out.to(q_k.dtype)


def memory_read_cuda(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                     slot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel.  Raises on what it does not take; never falls back."""
    global launches
    if not (q_k.is_cuda and m_k.is_cuda and m_v.is_cuda):
        raise ValueError("memory_read_cuda needs CUDA tensors")
    if q_k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"memory_read_cuda: dtype {q_k.dtype} not supported")
    if not (m_k.dtype == m_v.dtype == q_k.dtype):
        raise TypeError("memory_read_cuda: q, keys and values must share a dtype")
    if q_k.dim() != 3 or m_k.dim() != 4 or m_v.dim() != 4:
        raise ValueError("memory_read_cuda: want q [B,HW,Ck], bank [B,T,HW,C]")
    b, hw, ck = q_k.shape
    t = m_k.shape[1]
    cv = m_v.shape[-1]
    if tuple(m_k.shape) != (b, t, hw, ck) or tuple(m_v.shape[:3]) != (b, t, hw):
        raise ValueError(f"memory_read_cuda: shapes q {tuple(q_k.shape)}, keys "
                         f"{tuple(m_k.shape)}, values {tuple(m_v.shape)} disagree")
    if ck not in _KEY_DIMS or cv % _CV_SLICE or t > _MAX_SLOTS:
        raise ValueError(f"memory_read_cuda: Ck={ck} (want {_KEY_DIMS}), Cv={cv} "
                         f"(want a multiple of {_CV_SLICE}), T={t} (max {_MAX_SLOTS})")
    if not (q_k.is_contiguous() and m_k.is_contiguous() and m_v.is_contiguous()):
        raise ValueError("memory_read_cuda: inputs must be contiguous")
    if slot_mask is None:
        mask = torch.ones((b, t), dtype=torch.uint8, device=q_k.device)
    else:
        if tuple(slot_mask.shape) != (b, t):
            raise ValueError(f"memory_read_cuda: slot_mask {tuple(slot_mask.shape)} != {(b, t)}")
        mask = slot_mask.to(device=q_k.device, dtype=torch.uint8).contiguous()
    lib = build()
    out = torch.empty((b, hw, cv), dtype=q_k.dtype, device=q_k.device)
    with torch.cuda.device(q_k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.otvm_memory_read(q_k.data_ptr(), m_k.data_ptr(), m_v.data_ptr(),
                                   mask.data_ptr(), out.data_ptr(), b, hw, t, ck, cv,
                                   int(q_k.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"memory_read kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def memory_read(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                slot_mask: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors.
    impl='plain' asks for the plain version on any device (for comparisons
    with the kernel); it is never the default on CUDA."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown memory_read impl {impl!r}")
    if impl == "plain" or not q_k.is_cuda:
        return memory_read_plain(q_k, m_k, m_v, slot_mask)
    return memory_read_cuda(q_k, m_k, m_v, slot_mask)
