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

Tensor parallelism (``mesh=``, a :class:`repro_torch.launch.mesh.ServingMesh`
of T shard devices): the KV arena is one contiguous ``[L, P, page, Hkv/T,
D]`` slab per shard and the model one ``DecoderLM`` of weight slices per
shard (``sharding/rules.py``).  The pool, the grant, COW planning, token
routing, selection and OA validation run once, on the lead device — the
reference replicates them and every shard computes the same values, so one
copy is the same single logical pool.  Per layer each shard projects its
q/k/v heads, appends to its own slab and attends on its heads (one launch
of the sharded kernel per shard, the append fused in), and multiplies by
its rows of ``wo``; the partial outputs are summed into the residual on
the lead device (the reference's ``psum``), and the MLP does the same with
its ``w_gate``/``w_up`` columns and ``w_down`` rows.

Where the JAX step donates its state, this one updates it IN PLACE: the KV
arena (the attention launch's fused append and the COW copy write into
it), the pool's tensors, the block tables, the snapshots, ``lengths`` and
``last_tok`` are written through and also returned.  On CUDA tensors each
layer's KV append and attention are ONE launch of the hand-written kernel
per shard (``kernels/ops.py``, ``paged_attention(..., append=...)``): the
new K/V are written to the arena and read once, on the step's stream; on
CPU tensors the plain append, then plain attention.  The JAX step's
``lax.scan`` over layers is a Python loop over ``model.blocks``; its
traced ``do_validate`` and ``chunk_budget`` are plain host values the
scheduler already plans.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import pagepool as pp
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import paged_attention, speculative_accept
from repro_torch.models.layers import apply_norm, attention_qkv, mlp_apply
from repro_torch.models.transformer import embed_tokens, unembed
from repro_torch.launch.mesh import ServingMesh
from repro_torch.sharding.rules import (ROW_BIASES, lm_head_split, mlp_split,
                                        paged_kv_axis)


def kv_storage_init(cfg, num_pages: int, page_size: int,
                    dtype=torch.bfloat16, device=None, mesh=None):
    """The persistent all-layer KV arena [L, P, page, Hkv, D] (pages stay
    addressable forever; stale reads validate, never fault).

    With ``mesh``: a list of T contiguous slabs [L, P, page, Hkv/T, D], shard
    s's holding KV heads ``[s·Hkv/T, (s+1)·Hkv/T)`` of every page on
    ``mesh.devices[s]`` (``sharding.rules.paged_kv_axis``).  A head count T
    does not divide raises ``ValueError``: the reference's replicated-arena
    layout for that case is not ported."""
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if mesh is None:
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if paged_kv_axis(shape, mesh.tp) is None:
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} is not divisible by tensor_parallel="
            f"{mesh.tp}: the replicated KV arena the reference falls back to "
            f"is not ported yet")
    local = shape[:3] + (cfg.n_kv_heads // mesh.tp, cfg.head_dim)
    return [{"k": torch.zeros(local, dtype=dtype, device=d),
             "v": torch.zeros(local, dtype=dtype, device=d)}
            for d in mesh.devices]


def max_chunk_pages(chunk_size: int, page_size: int) -> int:
    """Most pages a ``chunk_size``-token append can touch: the chunk's first
    token may land on the last slot of a page, so C tokens straddle at most
    ``1 + ceil((C-1)/page_size)`` pages (== 1 for the decode case C=1)."""
    return 1 + (max(chunk_size, 1) - 1 + page_size - 1) // page_size


@functools.cache
def _local_cfg(cfg, tp: int):
    """The config one of ``tp`` shards computes its heads with."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp)


def _layout(model, kv, mesh, dev):
    """(shard models, shard arenas, mesh): without a mesh, one shard of
    everything on ``dev``."""
    if mesh is None:
        return [model], [kv], ServingMesh((dev,), 1)
    return list(model), list(kv), mesh


def _reduce(parts, dev):
    """The shards' partial outputs summed on ``dev`` (the reference's
    ``psum`` at a row-parallel product); one part is returned as it is."""
    out = parts[0].to(dev, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(dev, non_blocking=True)
    return out


def _mlp_partial(cfg, h, p):
    """One shard's MLP output before the row-parallel sum: without the
    row-parallel biases, which the caller adds once after the sum."""
    return mlp_apply(cfg, h, {k: v for k, v in p.items()
                              if k not in ROW_BIASES})


def _unembed(cfg, shards, mesh, x):
    """Logits from the lead's tied table or whole ``lm_head``, or the
    shards' ``lm_head`` column slices joined on the vocab axis."""
    if not lm_head_split(cfg, mesh.tp):
        return unembed(cfg, shards[0], x)
    return torch.cat([(x.to(d, non_blocking=True) @ m.lm_head).to(
        x.device, non_blocking=True) for m, d in zip(shards, mesh.devices)],
        dim=-1)


def _chunk_core(model, kv, block_tables, lengths, tokens, n_new, *, cfg,
                pages_per_compute_block: int = 1, write_ok=None, mesh=None):
    """Model math for a C-token chunk per row (C = 1 is plain decode).

    tokens [B, C] — chunk inputs at positions ``lengths[b] + j``; n_new [B]
    (1..C) live tokens per row: appends for j >= n_new are masked and query
    j gets the causal horizon of its position.  ``write_ok`` [B] bool masks
    all of a row's appends (a starved COW row must not write the shared page
    it failed to diverge from).  Each layer writes its K/V into the arena in
    place and attends over them in one ``paged_attention(..., append=...)``
    call (one kernel launch per shard on CUDA).  With ``mesh``, ``model``
    and ``kv`` are the per-shard models and slabs (module docstring).
    Returns (x [B, C, d_model] final-normed, kv)."""
    if cfg.family != "dense" or cfg.moe:
        raise NotImplementedError("paged decode: dense decoder LMs only")
    B, C = tokens.shape
    dev = tokens.device
    shards, kvs, mesh = _layout(model, kv, mesh, dev)
    devs = mesh.devices
    lcfg = _local_cfg(cfg, mesh.tp)
    mlp_n = mesh.tp if mlp_split(cfg, mesh.tp) else 1
    positions = lengths.to(torch.int64)[:, None] + torch.arange(
        C, device=dev)[None, :]
    x = embed_tokens(cfg, shards[0].embed, tokens.to(torch.int64), positions)
    n_new = n_new.to(torch.int32)
    total_len = (lengths + n_new).to(torch.int32)
    if write_ok is None:
        write_ok = torch.ones((B,), dtype=torch.bool, device=dev)
    poss, bts, nns, oks, tots = map(
        mesh.replicate, (positions, block_tables, n_new, write_ok, total_len))
    for layer in range(cfg.n_layers):
        blks = [m.blocks[layer] for m in shards]
        h = apply_norm(cfg, x, blks[0].ln1)
        qs, kns, vns, slabs = [], [], [], []
        for s, blk in enumerate(blks):
            kl, vl = kvs[s]["k"][layer], kvs[s]["v"][layer]  # [P,page,Hkv,D]
            q, k, v = attention_qkv(lcfg, h.to(devs[s], non_blocking=True),
                                    blk.attn, poss[s])
            qs.append(q)
            kns.append(k.to(kl.dtype).contiguous())
            vns.append(v.to(vl.dtype).contiguous())
            slabs.append({"k": kl, "v": vl})
        # the chunk's K/V land at positions lengths .. total_len - 1, then
        # are attended over: one call (per shard: one launch, one stream)
        atts = paged_attention(
            qs, slabs, bts, tots, mesh=mesh, chunk_lens=nns,
            pages_per_compute_block=pages_per_compute_block,
            append=(kns, vns, oks))
        x = x + _reduce([a.reshape(B, C, -1) @ blk.attn["wo"]
                         for a, blk in zip(atts, blks)], dev)
        h2 = apply_norm(cfg, x, blks[0].ln2)
        y = _reduce([_mlp_partial(cfg, h2.to(devs[s], non_blocking=True),
                                  blks[s].mlp) for s in range(mlp_n)], dev)
        for name in ROW_BIASES & blks[0].mlp.keys():
            y = y + blks[0].mlp[name].to(y.dtype)
        x = x + y
    return apply_norm(cfg, x, shards[0].final_norm), kv


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
                      chunk_size: int = 1, speculative: bool = False,
                      mesh=None):
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

    ``mesh``: tensor parallelism (module docstring) — ``model`` is then the
    sequence of shard models and ``kv`` the list of shard slabs; every other
    tensor lives on ``mesh.lead``.

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
    dev = block_tables.device
    shards, kvs, layout = _layout(model, kv, mesh, dev)
    page_size = kvs[0]["k"].shape[2]
    num_pages = kvs[0]["k"].shape[1]
    C = max(int(chunk_size), 1)
    MG = max_chunk_pages(C, page_size)
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
    for slab, d, s in zip(kvs, layout.replicate(dst),
                          layout.replicate(src)):  # every shard's slab
        for name in ("k", "v"):
            slab[name][:, d] = slab[name][:, s]
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
        pages_per_compute_block=pages_per_compute_block, write_ok=grant_ok,
        mesh=mesh)

    # (5) on-device token selection
    if speculative:
        tgt = torch.argmax(_unembed(cfg, shards, layout, x).float(),
                           dim=-1)  # [B, C]
        n_acc = speculative_accept(tgt, tok_in, dlens).to(i64)
        sel = torch.where(prefilling, torch.clamp(n_new - 1, 0, C - 1), n_acc)
        nxt = torch.gather(tgt, 1, sel[:, None])[:, 0]
        commit_n = torch.where(prefilling, n_new, n_acc + 1)
    else:
        last_idx = torch.clamp(n_new - 1, 0, C - 1)
        xl = torch.gather(x, 1, last_idx[:, None, None].expand(
            B, 1, x.shape[-1]))
        logits = _unembed(cfg, shards, layout, xl)[:, 0].float()
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
