"""Paged KV append, C tokens per row: the CUDA kernel and its plain version.

Port of the TPU kernel ``repro.kernels.kv_append.kv_append_pallas`` in its
C-token form (source: ``kernels/csrc/kv_append.cu``), which is exactly the
masked scatter the JAX serving step writes with jnp: token j of row b goes
to slot ``(lengths + j) % page`` of page ``block_tables[b, (lengths + j) //
page]`` unless ``j >= n_new``, the page is −1, the page slot is ``>= M`` or
``write_ok[b]`` is False.  Both versions write the arena IN PLACE.

:func:`kv_append_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`kv_append_plain` is the masked
``index_put_`` the dispatcher uses for CPU tensors and ``chip_smoke.py``
holds the kernel against (bit-exact: both move the same bits).
"""

from __future__ import annotations

import ctypes

import torch

from .build import count_launch, load, locked_cache


def _masks(k_pages, block_tables, lengths, n_new, write_ok, C):
    """Per-token (page, slot, live) for a [B, C] chunk (plain version)."""
    P, page = k_pages.shape[:2]
    M = block_tables.shape[1]
    pos = lengths.to(torch.int64)[:, None] + torch.arange(
        C, device=lengths.device)[None, :]
    pos_page = pos // page
    pages = torch.gather(block_tables.to(torch.int64), 1,
                         torch.clamp(pos_page, max=M - 1))
    live = ((torch.arange(C, device=lengths.device)[None, :] < n_new[:, None])
            & (pages >= 0) & (pages < P) & (pos_page < M) & write_ok[:, None])
    return pages, pos % page, live


def kv_append_plain(k_pages, v_pages, k_new, v_new, block_tables, lengths,
                    n_new, write_ok):
    """Masked ``index_put_`` of k_new/v_new [B, C, Hkv, D] into the arena
    k_pages/v_pages [P, page, Hkv, D], in place."""
    pages, slot, live = _masks(k_pages, block_tables, lengths, n_new,
                               write_ok, k_new.shape[1])
    b, j = torch.nonzero(live, as_tuple=True)
    k_pages.index_put_((pages[b, j], slot[b, j]), k_new[b, j].to(k_pages.dtype))
    v_pages.index_put_((pages[b, j], slot[b, j]), v_new[b, j].to(v_pages.dtype))


@locked_cache
def _launcher():
    """The kernel's C entry point, typed once per process."""
    fn = load("kv_append").kv_append_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"kv_append_cuda: {msg}")


def kv_append_cuda(k_pages, v_pages, k_new, v_new, block_tables, lengths,
                   n_new, write_ok):
    """k/v pages [P, page, Hkv, D] (one layer's arena, written in place);
    k_new/v_new [B, C, Hkv, D] of the arena's dtype; block_tables [B, M],
    lengths [B] and n_new [B] int32; write_ok [B] bool — all contiguous CUDA
    tensors on one device.  Launches on the inputs' device's current
    stream, no host read."""
    tensors = (k_pages, v_pages, k_new, v_new, block_tables, lengths, n_new,
               write_ok)
    _check(all(t.is_cuda for t in tensors), "every input must be a CUDA tensor")
    _check(len({t.device for t in tensors}) == 1, "inputs on different devices")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(k_pages.dtype in (torch.float32, torch.bfloat16)
           and all(t.dtype == k_pages.dtype for t in tensors[1:4]),
           "k/v pages and k/v new must share one float32 or bfloat16 dtype")
    _check(all(t.dtype == torch.int32 for t in tensors[4:7]),
           "block_tables, lengths and n_new must be int32")
    _check(write_ok.dtype == torch.bool, "write_ok must be bool")
    _check(k_pages.dim() == 4 and k_new.dim() == 4, "pages and new rows must "
           "be 4-D")
    P, page, Hkv, D = k_pages.shape
    B, C = k_new.shape[:2]
    _check(tuple(v_pages.shape) == tuple(k_pages.shape), "k/v shapes differ")
    _check(tuple(k_new.shape[2:]) == (Hkv, D)
           and tuple(v_new.shape) == tuple(k_new.shape), "row shapes differ")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B,
           "block_tables must be [B, M]")
    _check(all(tuple(t.shape) == (B,) for t in (lengths, n_new, write_ok)),
           "lengths, n_new and write_ok must be [B]")
    with torch.cuda.device(k_pages.device):  # launch on the inputs' device
        err = _launcher()(
            k_new.data_ptr(), v_new.data_ptr(), n_new.data_ptr(),
            write_ok.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), B, C,
            block_tables.shape[1], P, page, Hkv * D * k_pages.element_size(),
            torch.cuda.current_stream(k_pages.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kv_append kernel launch failed: CUDA error {err}")
    count_launch(kv_append_cuda)


#: launches of the CUDA kernel since the last reset (a plain integer)
kv_append_cuda.launches = 0
