"""Paged decode + chunked-prefill step for dense decoder LMs (PyTorch).

The port of ``repro.serving.paged_decode``: the same math, with the KV
cache in the versioned page pool — storage [L, P, page, Hkv, D], one block
table per sequence shared by all layers.

- ``paged_decode_step``: the bare model math — (logits, kv).
- ``fused_decode_step``: the serving hot path.  Page growth (one batched
  multi-page grant), copy-on-write of shared prefix pages, next-token
  routing (prompt replay vs. last sample), KV append, attention, token
  selection, speculative verification and the OA snapshot/validate
  protocol all run in one call that makes NO host read, so the engine's
  only per-step device→host transfer is its read of the six [B] results.

Where the JAX step donates its state, this one updates it IN PLACE: the KV
arena (the append kernel and the COW copy write into it), the pool's
tensors, the block tables, the snapshots, ``lengths`` and ``last_tok``
are written through and also returned.  On CUDA tensors the KV append and
attention run the hand-written kernels (``kernels/ops.py``); on CPU
tensors their plain PyTorch versions.  The JAX step's ``lax.scan`` over
layers is a Python loop over ``model.blocks``; its traced ``do_validate``
and ``chunk_budget`` are plain host values the scheduler already plans.
"""

from __future__ import annotations

import torch

from repro_torch.core import pagepool as pp
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import kv_append, paged_attention, speculative_accept
from repro_torch.models.layers import apply_norm, attention_qkv, mlp_apply
from repro_torch.models.transformer import embed_tokens, unembed


def kv_storage_init(cfg, num_pages: int, page_size: int,
                    dtype=torch.bfloat16, device=None):
    """The persistent all-layer KV arena [L, P, page, Hkv, D] (pages stay
    addressable forever; stale reads validate, never fault)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def max_chunk_pages(chunk_size: int, page_size: int) -> int:
    """Most pages a ``chunk_size``-token append can touch: the chunk's first
    token may land on the last slot of a page, so C tokens straddle at most
    ``1 + ceil((C-1)/page_size)`` pages (== 1 for the decode case C=1)."""
    return 1 + (max(chunk_size, 1) - 1 + page_size - 1) // page_size


def _chunk_core(model, kv, block_tables, lengths, tokens, n_new, *, cfg,
                pages_per_compute_block: int = 1, write_ok=None):
    """Model math for a C-token chunk per row (C = 1 is plain decode).

    tokens [B, C] — chunk inputs at positions ``lengths[b] + j``; n_new [B]
    (1..C) live tokens per row: appends for j >= n_new are masked and query
    j gets the causal horizon of its position.  ``write_ok`` [B] bool masks
    all of a row's appends (a starved COW row must not write the shared page
    it failed to diverge from).  Each layer writes its K/V into the arena in
    place, then attends.  Returns (x [B, C, d_model] final-normed, kv)."""
    if cfg.family != "dense" or cfg.moe:
        raise NotImplementedError("paged decode: dense decoder LMs only")
    B, C = tokens.shape
    dev = tokens.device
    positions = lengths.to(torch.int64)[:, None] + torch.arange(
        C, device=dev)[None, :]
    x = embed_tokens(cfg, model.embed, tokens.to(torch.int64), positions)
    n_new = n_new.to(torch.int32)
    total_len = (lengths + n_new).to(torch.int32)
    if write_ok is None:
        write_ok = torch.ones((B,), dtype=torch.bool, device=dev)
    for layer, blk in enumerate(model.blocks):
        kl, vl = kv["k"][layer], kv["v"][layer]  # [P, page, Hkv, D] views
        h = apply_norm(cfg, x, blk.ln1)
        q, k, v = attention_qkv(cfg, h, blk.attn, positions)
        # the write precedes attention in every layer, on the same stream
        kv_append(kl, vl, k.to(kl.dtype).contiguous(),
                  v.to(vl.dtype).contiguous(), block_tables, lengths, n_new,
                  write_ok)
        att = paged_attention(q, {"k": kl, "v": vl}, block_tables, total_len,
                              pages_per_compute_block=pages_per_compute_block,
                              chunk_lens=n_new)
        x = x + att.reshape(B, C, -1) @ blk.attn["wo"]
        h2 = apply_norm(cfg, x, blk.ln2)
        x = x + mlp_apply(cfg, h2, blk.mlp)
    return apply_norm(cfg, x, model.final_norm), kv


def paged_decode_step(model, kv, block_tables, lengths, tokens, *, cfg):
    """One token for every sequence: kv {'k','v': [L, P, page, Hkv, D]}
    (written in place); block_tables [B, max_pages] int32; lengths [B]
    int32 (the new token lands at ``lengths``); tokens [B].  Returns
    (logits [B, vocab] float32, kv)."""
    ones = torch.ones_like(lengths)
    x, kv = _chunk_core(model, kv, block_tables, lengths, tokens[:, None],
                        ones, cfg=cfg)
    return unembed(cfg, model, x)[:, 0].float(), kv


def _padded_set(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                keep: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``dst.at[rows, cols].set(val, mode="drop")`` on [B, M]: dropped
    entries land in a sentinel column M, sliced away afterwards."""
    M = dst.shape[1]
    pad = torch.cat([dst, dst.new_zeros((dst.shape[0], 1))], dim=1)
    pad[rows, torch.where(keep & (cols < M), cols, M)] = val.to(dst.dtype)
    return pad[:, :M]


def fused_decode_step(model, kv, pool, block_tables, snapshot, lengths,
                      last_tok, active, prompt_buf, prompt_len, generator,
                      temperature: float, chunk_budget: int = 1,
                      draft_toks=None, draft_lens=None,
                      do_validate: bool | None = None, *, cfg,
                      greedy: bool = True, pages_per_compute_block: int = 1,
                      chunk_size: int = 1, speculative: bool = False):
    """The sync-free batched step, covering up to ``chunk_size`` prompt
    tokens per prefilling row (the port of the JAX ``fused_decode_step``;
    its docstring describes the six phases in full).

    Device state, updated in place and returned: kv {'k','v': [L, P, page,
    Hkv, D]}; pool (:class:`repro_torch.core.pagepool.PagePool`);
    block_tables [B, M] int32 (−1 = unmapped); snapshot [B, M] int64
    (uint32 versions); lengths [B] int32; last_tok [B] int32.  Read only:
    active [B] bool; prompt_buf [B, cap] / prompt_len [B] int32.

    Host values: ``generator`` (a ``torch.Generator`` on the state's device,
    used only when ``greedy`` is False: Gumbel-max sampling);
    ``temperature``; ``chunk_budget`` (per-row chunk cap, clipped to
    [1, chunk_size]); ``draft_toks`` [B, chunk_size−1] / ``draft_lens``
    [B] device tensors (``speculative`` only); ``do_validate`` (None =
    True) — run the OA validation pass this step.

    Returns (kv, pool, block_tables, snapshot, lengths, last_tok,
    tokens [B] int32, valid [B] bool, grant_info [B] int32, cow [B] bool,
    adv [B] int32, n_acc [B] int32), as the reference does.
    """
    if speculative and not greedy:
        raise ValueError(
            "speculative=True requires greedy decoding: the accept scan "
            "compares the verifier's argmax, and lossless rejection "
            "sampling for temperature > 0 is not implemented")
    B, M = block_tables.shape
    page_size = kv["k"].shape[2]
    num_pages = kv["k"].shape[1]
    C = max(int(chunk_size), 1)
    MG = max_chunk_pages(C, page_size)
    dev = block_tables.device
    rows = torch.arange(B, device=dev)
    i64 = torch.int64
    ln = lengths.to(i64)
    plen = prompt_len.to(i64)

    # (1) per-row chunk sizing (device-side: no host knowledge of lengths)
    budget = min(max(int(chunk_budget), 1), C)
    prefilling = ln < plen
    if speculative:
        dlens = torch.where(active & ~prefilling,
                            torch.clamp(draft_lens.to(i64), 0, C - 1), 0)
        decode_n = 1 + dlens
    else:
        decode_n = torch.ones_like(ln)
    n_new = torch.where(active & prefilling,
                        torch.clamp(plen - ln, max=budget), decode_n)

    # (2) batched multi-page growth + COW in one grant
    p0 = ln // page_size
    plast = (ln + n_new - 1) // page_size
    koff = torch.arange(MG, device=dev)
    pis = p0[:, None] + koff[None, :]  # [B, MG] candidate page slots
    in_range = (pis <= plast[:, None]) & (pis < M)
    cur = torch.gather(block_tables.to(i64), 1, torch.clamp(pis, max=M - 1))
    cur0 = cur[:, 0]
    rc0 = pool.page_refcount[torch.clamp(cur0, 0, num_pages - 1)]
    # the chunk's FIRST written page is the only one that can be mapped yet
    # shared: diverge onto a private copy before the append can touch it
    need_copy = active & (cur0 >= 0) & (rc0 > 1)
    need_slot = in_range & (cur < 0) & active[:, None]
    need_slot = need_slot | (need_copy[:, None] & (koff == 0)[None, :])
    need = need_slot.sum(1)
    new_pool, grants, _ = pp._alloc_pages_batch_impl(pool, need, MG)
    # pack each row's grants onto its needing slots, in page order
    gidx = torch.cumsum(need_slot.to(i64), 1) - 1
    g = torch.gather(grants.to(i64), 1, torch.clamp(gidx, 0, MG - 1))
    g = torch.where(need_slot, g, -1)
    grant_n = (g >= 0).sum(1)
    grant_ok = (need == 0) | (grant_n == need)  # all-or-nothing per row
    # COW: copy the shared page's KV (all layers) into the fresh page.  Rows
    # without a copy repeat the first COW row's copy (or page 0 onto itself
    # when no row copies), so every write is either a real copy or a
    # duplicate of one — never a clobber, and never a host branch
    cow = need_copy & (g[:, 0] >= 0)
    first = torch.argmax(cow.to(torch.int32)).reshape(1)  # a tensor index:
    has = cow.any()  # indexing with it never reads the value on the host
    dst = torch.where(cow, g[:, 0], torch.where(has, g[first, 0], 0))
    src = torch.where(cow, cur0, torch.where(has, cur0[first], 0))
    for name in ("k", "v"):
        kv[name][:, dst] = kv[name][:, src]
    # ...and drop the row's reference on the original
    new_pool = pp._unshare_pages_impl(new_pool, torch.where(cow, cur0, -1))
    # install the grants and fold their versions into the snapshot
    put = g >= 0
    new_bt = _padded_set(block_tables, rows[:, None], pis, put, g)
    vers = new_pool.page_version[torch.clamp(g, 0, num_pages - 1)]
    new_snap = _padded_set(snapshot, rows[:, None], pis, put, vers)
    grant_info = torch.where(grant_ok, grant_n, -1).to(torch.int32)

    # (3) next input tokens: replay the prompt, then feed back the sample
    cap = prompt_buf.shape[1]
    pos = ln[:, None] + torch.arange(C, device=dev)[None, :]
    ptok = torch.gather(prompt_buf.to(i64), 1, torch.clamp(pos, max=cap - 1))
    if speculative:
        gen_in = torch.cat([last_tok[:, None], draft_toks], dim=1).to(i64)
    else:
        gen_in = last_tok.to(i64)[:, None]
    tok_in = torch.where(pos < plen[:, None], ptok, gen_in)

    # (4) model math (starved rows' appends are masked)
    block_tables.copy_(new_bt)
    x, kv = _chunk_core(
        model, kv, block_tables, lengths, tok_in, n_new, cfg=cfg,
        pages_per_compute_block=pages_per_compute_block, write_ok=grant_ok)

    # (5) on-device token selection
    if speculative:
        tgt = torch.argmax(unembed(cfg, model, x).float(), dim=-1)  # [B, C]
        n_acc = speculative_accept(tgt, tok_in, dlens).to(i64)
        sel = torch.where(prefilling, torch.clamp(n_new - 1, 0, C - 1), n_acc)
        nxt = torch.gather(tgt, 1, sel[:, None])[:, 0]
        commit_n = torch.where(prefilling, n_new, n_acc + 1)
    else:
        last_idx = torch.clamp(n_new - 1, 0, C - 1)
        xl = torch.gather(x, 1, last_idx[:, None, None].expand(
            B, 1, x.shape[-1]))
        logits = unembed(cfg, model, xl)[:, 0].float()
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            u = torch.rand(logits.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(
                torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
            nxt = torch.argmax(logits / max(temperature, 1e-6) + gumbel, -1)
        n_acc = torch.zeros_like(ln)
        commit_n = n_new
    samples = (ln + n_new) >= plen

    # (6) OA validation over every page the rows read (host-planned skip)
    if do_validate is None or do_validate:
        valid_oa = pp._validate_and_commit_impl(new_pool, block_tables,
                                                new_snap)[0]
    else:
        valid_oa = torch.ones((B,), dtype=torch.bool, device=dev)
    valid = valid_oa & active & grant_ok
    adv = torch.where(valid, commit_n, 0)
    pp.assign_pool(pool, new_pool)
    snapshot.copy_(new_snap)
    lengths.copy_(ln + adv)
    last_tok.copy_(torch.where(valid & samples, nxt, last_tok.to(i64)))
    return (kv, pool, block_tables, snapshot, lengths, last_tok,
            nxt.to(torch.int32), valid, grant_info, cow,
            adv.to(torch.int32), n_acc.to(torch.int32))
