"""Paged attention: the hand-written CUDA kernel and its plain version.

Port of the TPU kernel ``repro.kernels.paged_attention.paged_attention_pallas``
(source: ``kernels/csrc/paged_attention.cu``; its header note says what
bounds it and how the simple design answers).  Semantics are the Pallas
kernel's: C queries per row over the row's pages with the in-chunk causal
mask, −1 pages masked, float32 online softmax, zeros for rows of length 0.

:func:`paged_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`paged_attention_plain` is the same
function in plain PyTorch (the chunked oracle of ``kernels/ref.py``), which
the dispatcher in ``kernels/ops.py`` uses for CPU tensors and
``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load
from .ref import paged_attention_chunked_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths,
                          chunk_lens):
    """The kernel's function in plain PyTorch (the kernel's
    ``pages_per_compute_block`` only tiles its loop; results do not depend
    on it)."""
    return paged_attention_chunked_ref(q, k_pages, v_pages, block_tables,
                                       lengths, chunk_lens)


def _lib():
    lib = load("paged_attention")
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q, k_pages, v_pages, block_tables, lengths,
                         chunk_lens, pages_per_compute_block: int = 1):
    """q [B, C, Hq, D] and k/v pages [P, page, Hkv, D] (one layer's arena),
    each float32 or bfloat16; block_tables [B, M], lengths [B] and
    chunk_lens [B] int32, all contiguous CUDA tensors on one device.
    Returns [B, C, Hq, D] in q's dtype.  Launches on the current stream and
    never reads a device value on the host."""
    tensors = (q, k_pages, v_pages, block_tables, lengths, chunk_lens)
    _check(all(t.is_cuda for t in tensors), "every input must be a CUDA tensor")
    _check(len({t.device for t in tensors}) == 1, "inputs on different devices")
    _check(q.dtype in _DTYPES and k_pages.dtype in _DTYPES,
           "q and the pages must be float32 or bfloat16")
    _check(v_pages.dtype == k_pages.dtype, "k and v pages must share a dtype")
    _check(all(t.dtype == torch.int32 for t in tensors[3:]),
           "block_tables, lengths and chunk_lens must be int32")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(q.dim() == 4 and k_pages.dim() == 4, "q and pages must be 4-D")
    B, C, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    _check(tuple(v_pages.shape) == tuple(k_pages.shape), "k/v shapes differ")
    _check(Dk == D and Hkv > 0 and Hq % Hkv == 0, "head shapes do not match")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B,
           "block_tables must be [B, M]")
    _check(tuple(lengths.shape) == (B,) and tuple(chunk_lens.shape) == (B,),
           "lengths and chunk_lens must be [B]")
    ppcb = max(int(pages_per_compute_block), 1)
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(),
                 chunk_lens.data_ptr(), out.data_ptr(), B, C, Hq, Hkv, D,
                 page, block_tables.shape[1], P, ppcb, _DTYPES[q.dtype],
                 _DTYPES[k_pages.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (a plain integer)
paged_attention_cuda.launches = 0
