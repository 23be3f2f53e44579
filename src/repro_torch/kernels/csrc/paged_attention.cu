// Paged attention over the versioned KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention_pallas (body _kernel): online-softmax attention of C query
// tokens per row over the row's KV pages, found through the block table,
// with GQA (G = Hq / Hkv query heads per KV head), the in-chunk causal
// horizon min(len - cl + c + 1, len), -1 (unmapped) pages masked, page ids
// >= P clamped to P - 1, float32 m / l / acc with the m_safe / alpha /
// l >= 1e-30 guards, and rows of length 0 giving zeros.  Through
// kernels/paged_attention.py::paged_attention_sharded it also replaces
// paged_attention_sharded: one launch of this kernel per shard, on the
// shard's KV-head slab or, over a replicated multi-query arena, on its
// query slab and its own copy of the one KV head.
//
// What bounds it on the card: latency, not bytes or operations.  Each
// (row, kv head) reads every live K and V token of its row once, 2 * len *
// D elements, and does about 4 * C * G flops per element read: far below
// the ~295 flop/byte at which an H100's bf16 tensor cores, not its 3.35
// TB/s memory, would be the limit.  At the serving shapes (8 rows of
// 80-272 tokens) a launch moves 1.8-15 MB, 0.5-4.5 us at full rate, while
// one block walks a chain of dependent steps: the row's length (~0.6 us
// after a cold L2), its page ids and query rows (~1.5-2.5 us), the first
// K/V stage (~0.5-1 us; 4 us where 256 blocks load at once), a stage's
// products (~2-2.7 us for up to 32 query slots, 4.5 us for 64 at D =
// 256), the partial and the ticket (~1-2 us), the merge (one block
// pulling S partials from L2: ~2.5-3 us for 16 query slots, 6.5 us for 32
// and 12 us for 64 at D = 256).  Measured per block with
// tools/paged_attention_trace.py.  So the design keeps each block's chain
// short: few stages a block, every warp busy, small merges, and enough
// blocks to cover the SMs.
//
// Design, point by point (each measured on the card, PERF.md section 6):
//  1. Split-KV by the row's page count.  Grid (kv head x query group, row,
//     split s).  A row of n = min(ceil(len/page), M) pages has
//     S = min(max_splits, ceil(n / split_pages)) splits (S = 1 when n = 0),
//     computed on the device from lengths[b]: the host reads no length.
//     Split s takes pages [s*n/S, (s+1)*n/S); blocks with s >= S return at
//     once, and the grid's z is the split count of the widest table row.
//     split_pages and max_splits come from the wrapper's rule
//     (kernels/paged_attention.py::row_splits: split_pages = 16384 / (D *
//     page), so a split reads at most about 32 KB of K and 32 KB of V a
//     kv head in bf16; max_splits = 8), which reads only D and the page
//     size: never B, Hq, G, Hkv or the shard count, so every query head's
//     output is bitwise the same at every TP degree and head layout.  A
//     multi-query row of 80-272 tokens at D = 256 gets 2-5 splits of one
//     64-token stage each, where one constant S = 2 gave its block 2-9
//     dependent stages; a dense D = 128 row gets 1-3 splits, as S = 2 gave.
//     Each split writes a float32 partial (m, l, acc) to scratch from
//     torch.empty; the last split of a (row, head, query group) to take a
//     ticket (threadfence, atomicAdd on a zeroed int32 counter the wrapper
//     caches per device and stream) combines the S partials in the fixed
//     order s = 0..S-1, so the result does not depend on arrival order, and
//     resets the ticket.  A split whose pages are all -1 contributes m =
//     -inf, l = 0, and the merge skips it.  The merge starts all S loads of
//     an output group before it uses any (unrolled to kMaxSplits, float4),
//     4 groups a thread at a time (2 where two blocks share an SM).  A row
//     with one split writes its output from the registers, with no
//     partial and no ticket.
//  2. Asynchronous page loads.  A ring of kStages = 2 stages in shared
//     memory, each KT tokens of K and of V in the arena's dtype (rows
//     padded by 16 bytes, so ldmatrix reads are free of bank conflicts),
//     filled with cp.async 16 bytes at a time: stage i + 1 loads while
//     stage i computes.  KT = 64 tokens, 32 for a float32 arena at D = 256
//     (the stage size reads only D and the dtypes, for the same reason as
//     the split rule).  Each token row is loaded by kThreads / KT threads;
//     each of them fetches the row's page id one stage before the stage's
//     loads start, so no load waits on a block-table read.  An unmapped page or
//     a token past the split is not fetched (cp.async zero-fills it) and
//     its scores are masked.  The query rows come in by cp.async with the
//     first stage.  TMA is not used: every tile sits behind a block-table
//     lookup, and cp.async keeps the launch free of host-built tensor maps.
//  3. Tensor cores for bf16, warps split by work that never depends on the
//     head layout.  A block has 8 warps (256 threads): with one or two
//     blocks an SM, one warp a scheduler left every dependent ldmatrix and
//     mma latency exposed (4 warps: 5.9 us for a 64-slot stage at D = 256
//     and 19.7 us for its merge; 8 warps: 4.5 and 11.8 us).  When q and the arena are both bf16 a stage runs in
//     three steps, one __syncthreads apart.  (a) Scores: the block's query
//     slots against the stage's 16-token key slices, in 16-row query tiles;
//     the (tile, slice) pairs go round robin to the warps, each a 16x16
//     S = Q.K^T on mma.sync.m16n8k16 bf16 -> f32 (ldmatrix fragments; at
//     D = 256 as two chains, the even and the odd 16-column steps of D,
//     added at the end), masked, its row maxima to shared memory.
//     (b) Probabilities: each warp turns its pairs' scores into P =
//     exp(s - m_safe) against the row's new maximum over the whole stage,
//     stores P rounded to bf16 (as flash attention does) and the float32
//     row sums of its slice.  (c) P.V: each warp takes an eighth of the
//     output columns for every query tile and runs O = alpha * O + P.V over
//     the stage's slices in order (ldmatrix.trans for V); one thread a row
//     keeps l = alpha * l + the slices' sums in slice order.  So every
//     query row's scores, maxima, sums and products are taken in one order
//     that reads only the row, D and the stage size, whatever the number
//     of query tiles: a shard's launch over a slab of query heads or KV
//     heads gives bitwise the whole launch's heads, and at C = 1 with one
//     query tile every warp still works in P.V.
//     A block holds a query group of 16, 32 or 64 slots (C*G beyond it
//     forms more groups, each a block that reads the row's K/V again, from
//     L2): the launch takes the fewest whose blocks, at up to 4 splits a
//     row, fit on the card at once.  The group never changes a row's
//     arithmetic; it sets how many blocks share the work and how much one
//     block's merge reads (paligemma-3b's 128 slots at C = 16: groups of
//     32, a 17.2 us launch, against 25.1 us in groups of 64).  wgmma is not
//     used: its 64-row tile would be 3/4 or 15/16 padding at C = 1, and
//     with groups of 16-32 slots a stage's products are 2-2.7 us of a
//     10-17 us chain.
//  4. float32 stays float32.  When q or the arena is float32 the same
//     split, ring, masks, online softmax and merges run with the same
//     fragment layout, but the products are CUDA-core FMAs on float32
//     values: no TF32, no bf16 rounding of q or P.
//  5. pages_per_compute_block is not used: the stage size KT is fixed by D
//     and the dtypes.
//  6. The paged KV append, fused (template flag kAppend; replaces the TPU
//     kernel src/repro/kernels/kv_append.py::kv_append_pallas on the
//     serving path, where kernels/csrc/kv_append.cu ran as a launch of its
//     own before this one in every layer).  With k_new / v_new [B, C, Hkv,
//     D] in the arena's dtype and write_ok [B] the launch computes exactly
//     "kv_append, then paged attention": token j of row b sits at position
//     t = len - cl + j and is written when j < cl, write_ok[b], t / page < M
//     and its page id is in [0, P).  A standalone append moves 8 rows of
//     4 KB at the serving shapes, ~40 ns of bytes under a launch of
//     microseconds, so the only design left is to do it inside a launch
//     that already runs and already holds the row's length and page ids.
//     Who writes: the block whose split owns t (the partition of point 1),
//     query group 0 only, each block its own kv head, so every written
//     (row, token, head) is written once and a TP shard writes only its
//     slab.  How: where load_stage meets a position it writes, the cp.async
//     source is the k_new / v_new row, not the arena; once the stage has
//     landed, each thread stores the chunks it loaded from the ring to the
//     arena.  Each new byte is read from device memory once, and the ring
//     holds the bits the two-launch order would have read back, so the
//     output is bitwise that of kv_append followed by this kernel.  Where
//     the append is masked (write_ok false, page -1 or >= P) the arena is
//     read as it is, as in the two-launch order: a starved copy-on-write
//     row never writes the page it shares.
//     The one case where fused and two-launch differ: row B reads, in the
//     same step, a slot that row A writes.  Live writes go only to private
//     pages (copy-on-write diverges the first written page; later pages
//     are fresh grants), so B can only do so through a block-table entry
//     of a page that was freed and granted again; that row fails OA
//     validation and its step is discarded.  That is the paper's
//     optimistic-access premise, and why the launch needs no grid-wide
//     barrier between the writes and the reads.  Append instantiations
//     exist where the engine needs them: q and arena of one dtype, and
//     float32 q over a bf16 arena (float32 weights, the default arena).
//  7. A sliding window (argument window = W > 0; 0 = none; the sliding
//     layers of trinity-mini, W = 2048).  Query slot c of a row sits at
//     position i = len - cl + c and sees key j when j < lim (its causal
//     horizon) and j >= lim - W.  The earliest key any query of the chunk
//     sees is lo = len - cl + 1 - W, so the splits of point 1 partition
//     the pages [p_lo, n) with p_lo = max(lo, 0) / page instead of [0, n):
//     a page wholly before lo is never fetched, its page id never looked
//     up, and the split count follows the pages left (at most
//     ceil((C - 1 + W) / page) + 1 of them), so a window layer's launch
//     over a 16k-token row reads about what one over a 2k-token row reads.
//     Keys of the first page below a query's window start are masked to
//     -inf like keys past its horizon.  Every appended token t >= len - cl
//     >= lo lies in the partition, so point 6's writers are unchanged.
//     With W = 0, p_lo = 0 and the lower mask is j >= 0: every expression
//     is the one without a window, so such launches are bitwise the same.
//  8. Only a row's live query slots are computed.  Slot qi = c * G + g is
//     live when c < cl = chunk_lens[b], so a row's live slots are its
//     first cl * G, contiguous.  A query group with none (q0 >= cl * G)
//     reads no page id, no query and no K/V, and takes no ticket: its
//     split 0 writes zeros to the group's slots and every block of it
//     returns.  A partly live group stages, computes, stores, writes to
//     the partials and merges only its first min(rows, cl * G - q0)
//     slots, whole 16-row query tiles past them are skipped, and its
//     split 0 writes zeros to the rest.  So the output's padded slots (c
//     >= cl) are exactly zero, and a row with cl = 0 gives zeros in every
//     slot.  What it saves: in trinity-mini's mixed [64, 32] step (G = 8:
//     256 slots a KV head in 4 groups of 64) a decoding row has 8 live
//     slots, so its groups 1-3 and 3 of group 0's 4 query tiles were
//     padding, each block re-reading the row's K/V for outputs nobody
//     reads; about half of the step's 16-row tiles.  Why a live slot's
//     arithmetic is unchanged: the group size (rows, chosen at launch from
//     C * G), the split rule, the stage size and every query row's order
//     of products read neither cl nor the group's live count (point 3),
//     so each live slot is bitwise what the launch computing every slot
//     gave.  Group 0 holds slot 0, so it is live whenever the row appends
//     (cl >= 1): point 6's writers are unchanged.  The plain version
//     (kernels/paged_attention.py) still gives a padded slot the horizon
//     len; no caller reads one.
//
// Launch: kThreads = 256 threads; dynamic shared memory laid out by Layout
// below (the host sizes it with the same struct).  Head dims 16, 32, 64,
// 128, 256.
// The append adds no shared memory: the stage ring carries the new rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // query rows per tile, tokens per slice
constexpr int kMaxRows = 64;       // query slots per block, at most
constexpr int kMaxTiles = kMaxRows / kTile;
constexpr int kStages = 2;         // cp.async ring depth
constexpr int kMaxSlices = 4;      // 16-token slices per stage (KT <= 64)
constexpr int kMaxPairs = kMaxTiles * kMaxSlices / kWarps;  // per warp
constexpr int kMaxSplits = 8;
constexpr int kMaxDevices = 64;
static_assert(kStages == 2, "the page-id prefetch assumes a 2-stage ring");

// tokens of K and of V per ring stage: reads only D and the arena's dtype
__host__ __device__ constexpr int stage_tokens(int D, int t_size) {
  return D == 256 && t_size == 4 ? 32 : 64;
}

// two neighbouring elements as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}
__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// two neighbouring values, in the destination's dtype
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// four neighbouring outputs, in the output's dtype
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float4 fma4(float f, float4 x, float4 acc) {
  return make_float4(fmaf(f, x.x, acc.x), fmaf(f, x.y, acc.y),
                     fmaf(f, x.z, acc.z), fmaf(f, x.w, acc.w));
}

// Shared-memory layout (byte offsets), shared by the kernel and the host.
// The ring is reused, after the key loop, for the merge's split weights.
struct Layout {
  int ks, qs, ps;  // K/V, Q and P row strides, in elements
  size_t q, p, lim, pid, mx, psum, m, alpha, l, bytes;
  __host__ __device__ Layout(int D, int t_size, int q_size, int KT,
                             int rows) {
    ks = D + 16 / t_size;
    qs = D + 16 / q_size;
    ps = KT + 16 / q_size;  // P is staged in q's staging dtype
    const size_t ring = (size_t)kStages * 2 * KT * ks * t_size;
    const size_t merge = (size_t)(kMaxSplits + 1) * rows * 4;
    q = align16(cmax(ring, merge));
    p = align16(q + (size_t)rows * qs * q_size);
    lim = align16(p + (size_t)rows * ps * q_size);
    pid = align16(lim + (size_t)rows * 4);
    mx = align16(pid + (size_t)kStages * KT * 4);
    psum = align16(mx + (size_t)kMaxSlices * rows * 4);
    m = align16(psum + (size_t)kMaxSlices * rows * 4);
    alpha = align16(m + (size_t)2 * rows * 4);
    l = align16(alpha + (size_t)rows * 4);
    bytes = align16(l + (size_t)rows * 4);
  }
};

template <typename TQ, typename T, int D, bool kAppend>
__global__ void __launch_bounds__(kThreads, sizeof(TQ) == 2 && sizeof(T) == 2 &&
                                               D <= 128 ? 2 : 1)
paged_attention_kernel(const TQ* __restrict__ q,         // [B, C, Hq, D]
                       const T* __restrict__ k_pages,    // [P, page, Hkv, D]
                       const T* __restrict__ v_pages,    // [P, page, Hkv, D]
                       const int* __restrict__ block_tables,  // [B, M]
                       const int* __restrict__ lengths,       // [B]
                       const int* __restrict__ chunk_lens,    // [B]
                       TQ* __restrict__ out,             // [B, C, Hq, D]
                       float* __restrict__ part,         // grid z > 1
                       int* __restrict__ tickets,        // grid z > 1: zeroed
                       int C, int Hq, int Hkv, int page, int M, int P,
                       int max_splits, int split_pages, int KT, int rows,
                       int window,                       // 0: none (point 7)
                       const T* __restrict__ k_new,      // kAppend: [B, C, Hkv, D]
                       const T* __restrict__ v_new,      // kAppend: [B, C, Hkv, D]
                       const uint8_t* __restrict__ write_ok) {  // kAppend: [B]
  constexpr bool kMma =
      sizeof(TQ) == 2 && sizeof(T) == 2;  // both bf16: tensor cores
  using QS = typename std::conditional<kMma, __nv_bfloat16, float>::type;
  constexpr int NT = D / 8;                             // 8-column tiles
  constexpr int NTW = NT >= kWarps ? NT / kWarps : 1;   // a warp's, in P.V
  constexpr int D4 = D / 4;  // float4 groups per query row

  const int G = Hq / Hkv;
  const int NQ = C * G;  // query slot qi = c * G + g  <->  head h * G + g
  const int NQG = (NQ + rows - 1) / rows;  // query groups of `rows` slots
  const int h = blockIdx.x / NQG, qg = blockIdx.x % NQG;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int S_grid = gridDim.z;

  // the row's split count (point 1): from its page count, D and the page
  // size alone, through split_pages and max_splits; with a window, from
  // the pages from the chunk's first window start on (point 7)
  const int len = lengths[b];
  const int cl = chunk_lens[b];  // (read beside len: one round trip)
  int n_pages = len > 0 ? (len + page - 1) / page : 0;
  if (n_pages > M) n_pages = M;
  int p_lo = 0;
  if (window > 0) {
    const int lo = len - cl + 1 - window;
    p_lo = lo > 0 ? min(lo / page, n_pages) : 0;
  }
  const int n_vis = n_pages - p_lo;
  const int S = n_vis == 0
                    ? 1
                    : min(max_splits, (n_vis + split_pages - 1) / split_pages);

  // the group's slots [q0, q0 + n_grp), of which the first nrow are live
  // (point 8); split 0 writes zeros to the others
  const int q0 = qg * rows;
  const int n_grp = min(rows, NQ - q0);
  const int nrow = max(min(n_grp, min(max(cl, 0), C) * G - q0), 0);
  if (s == 0 && nrow < n_grp) {
    constexpr int OCH = D * (int)sizeof(TQ) / 16;  // 16-byte chunks a slot
    for (int i = threadIdx.x; i < (n_grp - nrow) * OCH; i += kThreads) {
      const int qi = q0 + nrow + i / OCH, c = qi / G, g = qi - (qi / G) * G;
      reinterpret_cast<uint4*>(
          out + (((long long)b * C + c) * Hq + (long long)h * G + g) * D)
          [i % OCH] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (nrow == 0 || s >= S) return;  // (block-uniform)

  const int NQT = (nrow + kTile - 1) / kTile;  // 16-row query tiles
  const int KS = KT / kTile;                   // 16-token slices per stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Layout L(D, sizeof(T), sizeof(QS), KT, rows);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][2][KT][ks]
  QS* q_s = reinterpret_cast<QS*>(smem + L.q);        // [rows][qs]
  QS* p_s = reinterpret_cast<QS*>(smem + L.p);        // [rows][ps]
  int* lim_s = reinterpret_cast<int*>(smem + L.lim);  // [rows]
  int* pid_s = reinterpret_cast<int*>(smem + L.pid);  // [kStages][KT]
  float* mx_s = reinterpret_cast<float*>(smem + L.mx);    // [slice][rows]
  float* ps_s = reinterpret_cast<float*>(smem + L.psum);  // [slice][rows]
  float* m_s = reinterpret_cast<float*>(smem + L.m);      // [2][rows]
  float* al_s = reinterpret_cast<float*>(smem + L.alpha);  // [rows]
  float* l_s = reinterpret_cast<float*>(smem + L.l);       // [rows]
  __shared__ int is_last;

  const int t0 = (p_lo + (s * n_vis) / S) * page;
  const int t1 = min((p_lo + (s + 1) * n_vis / S) * page, len);
  const int n_stages = t1 > t0 ? (t1 - t0 + KT - 1) / KT : 0;
  const long long page_stride = (long long)page * Hkv * D;
  const float scale = 1.0f / sqrtf((float)D);
  // append mode: the chunk starts at t_new; wok is the row's write_ok
  const int t_new = len - cl;
  bool wok = false;
  if constexpr (kAppend) wok = write_ok[b] != 0;
  // does this launch write token t (page id pid, t < t1)?  then its k/v
  // row is k_new / v_new [b, t - t_new, h], not the arena's
  auto fresh = [&](int t, int pid) {
    return kAppend && wok && t >= t_new && t - t_new < C && pid >= 0 &&
           pid < P;
  };

  // one stage: KT token rows of K and V in 16-byte cp.async chunks, each
  // row loaded by kThreads / KT threads; tokens past the split and
  // unmapped pages are zero-filled, not read.  A thread's page id for a
  // stage is fetched one stage ahead (lookup), so no load waits on it.
  constexpr int CPT = D * (int)sizeof(T) / 16;  // chunks per token row
  constexpr int EPC = 16 / (int)sizeof(T);      // elements per chunk
  const int tpt = kThreads / KT;                // threads per token row
  const int my_row = tid / tpt, my_c0 = tid % tpt;
  auto lookup = [&](int st) {  // -1: unmapped, or past the split
    const int t = t0 + st * KT + my_row;
    return st < n_stages && t < t1
               ? __ldg(block_tables + (long long)b * M + t / page)
               : -1;
  };
  auto load_stage = [&](int st, int pid) {
    const int buf = st % kStages;
    T* k_dst = ring + (size_t)buf * 2 * KT * L.ks + (size_t)my_row * L.ks;
    T* v_dst = k_dst + (size_t)KT * L.ks;
    const int t = t0 + st * KT + my_row;
    const bool live = pid >= 0;
    const int pc = pid >= P ? P - 1 : pid;  // the reference's gathers clamp
    const long long off =
        live ? (long long)pc * page_stride + ((long long)(t % page) * Hkv + h) * D
             : 0;
    const T* k_src = k_pages + off;
    const T* v_src = v_pages + off;
    if constexpr (kAppend) {
      if (fresh(t, pid)) {
        const long long n = (((long long)b * C + (t - t_new)) * Hkv + h) * D;
        k_src = k_new + n;
        v_src = v_new + n;
      }
    }
    for (int c = my_c0; c < CPT; c += tpt) {
      cp_async16(k_dst + c * EPC, k_src + c * EPC, live ? 16 : 0);
      cp_async16(v_dst + c * EPC, v_src + c * EPC, live ? 16 : 0);
    }
    if (my_c0 == 0) pid_s[buf * KT + my_row] = pid;
  };

  // append mode, once stage st has landed: the chunks this thread loaded
  // of a token the launch appends go from the ring to the arena (its own
  // cp.async writes are visible to it after the wait; the ring slot is
  // refilled only after the next __syncthreads).  Query group 0 writes.
  auto store_stage = [&](int st, int pid) {
    const int t = t0 + st * KT + my_row;
    if (qg != 0 || !fresh(t, pid)) return;
    const T* k_src =
        ring + (size_t)(st % kStages) * 2 * KT * L.ks + (size_t)my_row * L.ks;
    const T* v_src = k_src + (size_t)KT * L.ks;
    const long long off =
        (long long)pid * page_stride + ((long long)(t % page) * Hkv + h) * D;
    T* k_dst = const_cast<T*>(k_pages) + off;  // written only here
    T* v_dst = const_cast<T*>(v_pages) + off;
    for (int c = my_c0; c < CPT; c += tpt) {
      *reinterpret_cast<uint4*>(k_dst + c * EPC) =
          *reinterpret_cast<const uint4*>(k_src + c * EPC);
      *reinterpret_cast<uint4*>(v_dst + c * EPC) =
          *reinterpret_cast<const uint4*>(v_src + c * EPC);
    }
  };

  int pid_cur = lookup(0);  // this thread's token row of stage 0

  // stage the block's live query rows (the rest are zeros and see nothing):
  // cp.async where q is stored in the staging dtype, with stage 0's group
  if constexpr (sizeof(TQ) == sizeof(QS)) {
    constexpr int QCPR = D * (int)sizeof(QS) / 16;  // chunks per query row
    constexpr int QEPC = 16 / (int)sizeof(QS);
    for (int i = tid; i < rows * QCPR; i += kThreads) {
      const int r = i / QCPR, c = i - (i / QCPR) * QCPR;
      const TQ* src = q;
      if (r < nrow) {
        const int qi = q0 + r, cc = qi / G, g = qi - (qi / G) * G;
        src = q + (((long long)b * C + cc) * Hq + (long long)h * G + g) * D +
              c * QEPC;
      }
      cp_async16(q_s + (size_t)r * L.qs + c * QEPC, src, r < nrow ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - (i / D) * D;
      float x = 0.f;
      if (r < nrow) {
        const int qi = q0 + r, cc = qi / G, g = qi - (qi / G) * G;
        x = __bfloat162float(  // only q bf16 over a float32 arena lands here
            q[(((long long)b * C + cc) * Hq + (long long)h * G + g) * D + d]);
      }
      q_s[(size_t)r * L.qs + d] = x;
    }
  }
  for (int r = tid; r < rows; r += kThreads) {
    int lim = 0;
    if (r < nrow) {
      // query slot c (live: c < cl) sits at global position len - cl + c
      // and sees positions below that + 1
      const int c = (q0 + r) / G;
      lim = min(len - cl + c + 1, len);
    }
    lim_s[r] = lim;
    m_s[r] = m_s[rows + r] = -INFINITY;
  }

  // per-thread state: in P.V, rows r0 = lane/4 and r0 + 8 of each query
  // tile, output columns c0 + nt*8 + (lane%4)*2 + {0,1} (the mma
  // accumulator layout) of the warp's column quarter c0; one thread a row
  // keeps the row's l
  const int r0 = lane >> 2;
  const int c0 = warp * NTW * 8;
  const bool pv_warp = c0 < D;
  float o[kMaxTiles][NTW][4];
#pragma unroll
  for (int qt = 0; qt < kMaxTiles; ++qt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      o[qt][nt][0] = o[qt][nt][1] = o[qt][nt][2] = o[qt][nt][3] = 0.f;
  float l_own = 0.f;

  if (n_stages > 0) load_stage(0, pid_cur);
  cp_async_commit();
  int pid_nxt = lookup(1);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<0>();  // stage st has landed (the only group in flight)
    if constexpr (kAppend) store_stage(st, pid_cur);
    __syncthreads();  // (1) stage st visible; stage st - 1 fully consumed
    if (st + 1 < n_stages) load_stage(st + 1, pid_nxt);
    cp_async_commit();
    const int pid_after = lookup(st + 2);

    const int buf = st % kStages;
    const int par = st & 1;  // m_s[par]: the maxima before this stage
    const int tt0 = t0 + st * KT;
    const T* k_st = ring + (size_t)buf * 2 * KT * L.ks;
    const T* v_st = k_st + (size_t)KT * L.ks;
    const int* pid_st = pid_s + buf * KT;
    const float* m_old = m_s + par * rows;
    const int npairs = NQT * KS;

    // (a) scores of the warp's (query tile, key slice) pairs:
    // sc[j][nt][0..1] row r0, sc[j][nt][2..3] row r0 + 8, keys
    // nt*8 + (lane%4)*2 + {0,1}; masked scores are -inf
    float sc[kMaxPairs][2][4];
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int i = warp + j * kWarps;
      if (i >= npairs) break;  // (warp-uniform)
      const int qt = i / KS, ksl = i - (i / KS) * KS;
      const int tt = tt0 + ksl * kTile;  // first token of the slice
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        sc[j][nt][0] = sc[j][nt][1] = sc[j][nt][2] = sc[j][nt][3] = 0.f;
      if (tt < t1) {  // (warp-uniform) a slice wholly past the split: masked
        const T* k_sl = k_st + (size_t)ksl * kTile * L.ks;
        const QS* q_t = q_s + (size_t)qt * kTile * L.qs;
        if constexpr (kMma) {
          // at D = 256 two chains of products, even and odd 16-column
          // steps of D, added at the end: half the dependent tensor-core
          // latency of the longest chain
          constexpr bool kTwo = D >= 256;
          float odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4], kb[4];
            ldsm_x4(a, q_t + (size_t)((mi & 1) * 8 + mr) * L.qs + kk * 16 +
                           (mi >> 1) * 8);
            ldsm_x4(kb, k_sl + (size_t)((mi >> 1) * 8 + mr) * L.ks + kk * 16 +
                            (mi & 1) * 8);
            float (&c)[2][4] = kTwo && kk % 2 ? odd : sc[j];
            mma_bf16(c[0], a, kb[0], kb[1]);
            mma_bf16(c[1], a, kb[2], kb[3]);
          }
          if constexpr (kTwo) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[j][nt][e] += odd[nt][e];
          }
        } else {
          const QS* qa = q_t + (size_t)r0 * L.qs;
          const QS* qb = qa + (size_t)8 * L.qs;
#pragma unroll 4
          for (int d = 0; d < D; d += 2) {
            const float2 xa = load2(qa + d), xb = load2(qb + d);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float2 kv = load2(
                    k_sl + (size_t)(nt * 8 + (lane & 3) * 2 + e) * L.ks + d);
                sc[j][nt][e] = fmaf(xa.y, kv.y, fmaf(xa.x, kv.x, sc[j][nt][e]));
                sc[j][nt][2 + e] =
                    fmaf(xb.y, kv.y, fmaf(xb.x, kv.x, sc[j][nt][2 + e]));
              }
          }
        }
      }
      const int ra = qt * kTile + r0;
      const int lim0 = lim_s[ra], lim1 = lim_s[ra + 8];
      // the window's first key of each row (point 7); 0 without one
      const int lo0 = window > 0 ? lim0 - window : 0;
      const int lo1 = window > 0 ? lim1 - window : 0;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = nt * 8 + (lane & 3) * 2 + e;
          const bool ok = tt < t1 && pid_st[ksl * kTile + key] >= 0;
          sc[j][nt][e] = ok && tt + key < lim0 && tt + key >= lo0
                             ? sc[j][nt][e] * scale
                             : -INFINITY;
          sc[j][nt][2 + e] = ok && tt + key < lim1 && tt + key >= lo1
                                 ? sc[j][nt][2 + e] * scale
                                 : -INFINITY;
          mx[0] = fmaxf(mx[0], sc[j][nt][e]);
          mx[1] = fmaxf(mx[1], sc[j][nt][2 + e]);
        }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      }
      if ((lane & 3) == 0) {
        mx_s[ksl * rows + ra] = mx[0];
        mx_s[ksl * rows + ra + 8] = mx[1];
      }
    }
    __syncthreads();  // (2) every slice's row maxima

    // (b) probabilities against the row's maximum over the whole stage:
    // P to p_s (bf16 for the tensor cores), the slice's row sums to ps_s;
    // slice 0's warp records alpha and the new maximum
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int i = warp + j * kWarps;
      if (i >= npairs) break;
      const int qt = i / KS, ksl = i - (i / KS) * KS;
      const int ra = qt * kTile + r0;
      float m_safe[2], sum[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = ra + 8 * x;
        float m_new = m_old[r];
#pragma unroll
        for (int k = 0; k < kMaxSlices; ++k)
          if (k < KS) m_new = fmaxf(m_new, mx_s[k * rows + r]);
        m_safe[x] = isfinite(m_new) ? m_new : 0.f;
        if (ksl == 0 && (lane & 3) == 0) {
          al_s[r] = isfinite(m_old[r]) ? expf(m_old[r] - m_safe[x]) : 0.f;
          m_s[(par ^ 1) * rows + r] = m_new;
        }
        sum[x] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sc[j][nt][e];
          p[e] = v == -INFINITY ? 0.f : expf(v - m_safe[e >> 1]);
          sum[e >> 1] += p[e];
        }
        const int col = ksl * kTile + nt * 8 + (lane & 3) * 2;
        store2(p_s + (size_t)ra * L.ps + col, p[0], p[1]);
        store2(p_s + (size_t)(ra + 8) * L.ps + col, p[2], p[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 1);
        sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 2);
      }
      if ((lane & 3) == 0) {
        ps_s[ksl * rows + ra] = sum[0];
        ps_s[ksl * rows + ra + 8] = sum[1];
      }
    }
    __syncthreads();  // (3) P, alpha and the slice sums

    // (c) O = alpha * O + P.V over the stage's slices, in slice order, on
    // the warp's columns of every query tile; l in its row's thread
    if (tid < nrow) {
      float add = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxSlices; ++k)
        if (k < KS) add += ps_s[k * rows + tid];
      l_own = l_own * al_s[tid] + add;
    }
    if (pv_warp) {
#pragma unroll
      for (int qt = 0; qt < kMaxTiles; ++qt) {
        if (qt >= NQT) break;
        const float a0 = al_s[qt * kTile + r0], a1 = al_s[qt * kTile + r0 + 8];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          o[qt][nt][0] *= a0;
          o[qt][nt][1] *= a0;
          o[qt][nt][2] *= a1;
          o[qt][nt][3] *= a1;
        }
        const QS* p_t = p_s + (size_t)qt * kTile * L.ps;
#pragma unroll
        for (int ksl = 0; ksl < kMaxSlices; ++ksl) {
          if (ksl >= KS || tt0 + ksl * kTile >= t1) break;  // P is 0 there
          const T* v_sl = v_st + (size_t)ksl * kTile * L.ks + c0;
          if constexpr (kMma) {
            const int mi = lane >> 3, mr = lane & 7;
            uint32_t pa[4];
            ldsm_x4(pa, p_t + (size_t)((mi & 1) * 8 + mr) * L.ps +
                            ksl * kTile + (mi >> 1) * 8);
            if constexpr (NTW >= 2) {
#pragma unroll
              for (int dp = 0; dp < NTW / 2; ++dp) {
                uint32_t vb[4];
                ldsm_x4_t(vb, v_sl + (size_t)((mi & 1) * 8 + mr) * L.ks +
                                  dp * 16 + (mi >> 1) * 8);
                mma_bf16(o[qt][2 * dp], pa, vb[0], vb[1]);
                mma_bf16(o[qt][2 * dp + 1], pa, vb[2], vb[3]);
              }
            } else {
              uint32_t vb[2];
              ldsm_x2_t(vb, v_sl + (size_t)(lane & 15) * L.ks);
              mma_bf16(o[qt][0], pa, vb[0], vb[1]);
            }
          } else {
            const QS* pra = p_t + (size_t)r0 * L.ps + ksl * kTile;
            const QS* prb = pra + (size_t)8 * L.ps;
#pragma unroll 2
            for (int key = 0; key < kTile; ++key) {
              const float pa = pra[key], pb = prb[key];
              const T* vr = v_sl + (size_t)key * L.ks + (lane & 3) * 2;
#pragma unroll
              for (int nt = 0; nt < NTW; ++nt) {
                const float2 v = load2(vr + nt * 8);
                o[qt][nt][0] = fmaf(pa, v.x, o[qt][nt][0]);
                o[qt][nt][1] = fmaf(pa, v.y, o[qt][nt][1]);
                o[qt][nt][2] = fmaf(pb, v.x, o[qt][nt][2]);
                o[qt][nt][3] = fmaf(pb, v.y, o[qt][nt][3]);
              }
            }
          }
        }
      }
    }
    pid_cur = pid_nxt;
    pid_nxt = pid_after;
  }
  cp_async_wait<0>();
  if (tid < nrow) l_s[tid] = l_own;
  __syncthreads();  // l of every row; the ring is free for the merge
  const float* m_fin = m_s + (n_stages & 1) * rows;

  // one split: the output, from the registers
  const long long n_rows = (long long)gridDim.y * Hkv * S_grid * NQ;  // partials
  const long long base = ((long long)(b * Hkv + h) * S_grid) * NQ + q0;
  if (S == 1) {
    if (!pv_warp) return;
#pragma unroll
    for (int qt = 0; qt < kMaxTiles; ++qt) {
      if (qt >= NQT) break;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = qt * kTile + r0 + 8 * x;
        if (r >= nrow) continue;
        const int qi = q0 + r, c = qi / G, g = qi - (qi / G) * G;
        const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
        TQ* dst = out + (((long long)b * C + c) * Hq + (long long)h * G + g) * D +
                  c0 + (lane & 3) * 2;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          store2(dst + nt * 8, o[qt][nt][2 * x] * inv,
                 o[qt][nt][2 * x + 1] * inv);
      }
    }
    return;
  }

  // several splits: this split's partial (acc, then m and l)
  if (pv_warp) {
#pragma unroll
    for (int qt = 0; qt < kMaxTiles; ++qt) {
      if (qt >= NQT) break;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = qt * kTile + r0 + 8 * x;
        if (r >= nrow) continue;
        float* dst = part + (base + (long long)s * NQ + r) * D + c0 +
                     (lane & 3) * 2;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          store2(dst + nt * 8, o[qt][nt][2 * x], o[qt][nt][2 * x + 1]);
      }
    }
  }
  if (tid < nrow) {
    part[n_rows * D + base + (long long)s * NQ + tid] = m_fin[tid];
    part[n_rows * (D + 1) + base + (long long)s * NQ + tid] = l_s[tid];
  }

  // ticket: the last split of this (row, head, query group) to arrive
  // merges all S partials in the order s = 0..S-1
  __threadfence();
  __syncthreads();
  int* ticket = tickets + ((long long)b * Hkv + h) * NQG + qg;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* wt = reinterpret_cast<float*>(smem);  // [kMaxSplits][rows], the ring's
  float* l_tot = wt + (size_t)kMaxSplits * rows;  // [rows]
  const float* part_m = part + n_rows * D + base;
  const float* part_l = part + n_rows * (D + 1) + base;
  for (int r = tid; r < nrow; r += kThreads) {
    float mj[kMaxSplits], lj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)  // every load issued before use
      if (j < S) {
        mj[j] = __ldcg(part_m + (long long)j * NQ + r);
        lj[j] = __ldcg(part_l + (long long)j * NQ + r);
      }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < S) m = fmaxf(m, mj[j]);
    const float ms = isfinite(m) ? m : 0.f;
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < S) {
        const float f = isfinite(mj[j]) ? expf(mj[j] - ms) : 0.f;  // empty: skipped
        wt[j * rows + r] = f;
        l += lj[j] * f;
      }
    l_tot[r] = l;
  }
  __syncthreads();
  // kMergeItems output groups a thread at a time, every load started
  // before use (2 where two blocks share an SM: 128 registers a thread)
  constexpr int kMergeItems = D >= 256 ? 4 : 2;
  const int n_items = nrow * D4;
  for (int i0 = tid; i0 < n_items; i0 += kMergeItems * kThreads) {
    float4 x[kMergeItems][kMaxSplits];
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n_items) break;
      const int r = i / D4, d = (i - (i / D4) * D4) * 4;
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j)
        if (j < S && wt[j * rows + r] != 0.f)
          x[u][j] = __ldcg(reinterpret_cast<const float4*>(
              part + (base + (long long)j * NQ + r) * D + d));
    }
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n_items) break;
      const int r = i / D4, d = (i - (i / D4) * D4) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j)
        if (j < S && wt[j * rows + r] != 0.f)
          acc = fma4(wt[j * rows + r], x[u][j], acc);
      const int qi = q0 + r, c = qi / G, g = qi - (qi / G) * G;
      const float inv = 1.f / fmaxf(l_tot[r], 1e-30f);
      store4(out + (((long long)b * C + c) * Hq + (long long)h * G + g) * D + d,
             make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    }
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

template <typename TQ, typename T, int D, bool kAppend>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* lengths, const void* chunk_lens, void* out, void* part,
           void* tickets, const void* k_new, const void* v_new,
           const void* write_ok, int B, int C, int Hq, int Hkv, int page,
           int M, int P, int max_splits, int split_pages, int window,
           cudaStream_t stream) {
  constexpr bool kMma = sizeof(TQ) == 2 && sizeof(T) == 2;
  const int q_size = kMma ? 2 : 4;
  const int NQ = C * (Hq / Hkv);
  const int KT = stage_tokens(D, sizeof(T));
  // the widest table row's split count: the grid's z
  const int s_wide = (M + split_pages - 1) / split_pages;
  const int S_grid = M <= 0 ? 1 : (s_wide < max_splits ? s_wide : max_splits);
  if (S_grid > 1 && (part == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  // the device's opt-in limit, SM count and the attribute already set
  static int cap[kMaxDevices], sms[kMaxDevices], set[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    cudaDeviceGetAttribute(&cap[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  // query slots a block (point 3): the fewest of 16, 32, 64 whose blocks,
  // at up to 4 splits a row, fit on the card at once; a group's slots
  // never change a row's arithmetic, only how many blocks share the work
  // and how much one block's merge reads
  const int resident = sms[dev] * (D >= 256 ? 1 : 2);
  const int S_est = S_grid < 4 ? S_grid : 4;
  int group = kMaxRows;
  for (int g = kTile; g < kMaxRows; g *= 2)
    if ((long long)B * Hkv * ((NQ + g - 1) / g) * S_est <= resident) {
      group = g;
      break;
    }
  const int rows = ((NQ < group ? NQ : group) + kTile - 1) / kTile * kTile;
  const size_t bytes = Layout(D, sizeof(T), q_size, KT, rows).bytes;
  if (bytes > (size_t)cap[dev]) return (int)cudaErrorInvalidValue;
  if ((int)bytes > set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, T, D, kAppend>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    set[dev] = (int)bytes;
  }
  const dim3 grid(Hkv * ((NQ + rows - 1) / rows), B, S_grid);
  paged_attention_kernel<TQ, T, D, kAppend><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<const int*>(chunk_lens),
      static_cast<TQ*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), C, Hq, Hkv, page, M, P, max_splits,
      split_pages, KT, rows, window, static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const uint8_t*>(write_ok));
  return (int)cudaGetLastError();
}

template <typename TQ, typename T, bool kAppend>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* bt, const void* lengths, const void* chunk_lens,
             void* out, void* part, void* tickets, const void* k_new,
             const void* v_new, const void* write_ok, int B, int C, int Hq,
             int Hkv, int page, int M, int P, int max_splits, int split_pages,
             int window, cudaStream_t s) {
#define PA_D(DD)                                                              \
  if (D == DD)                                                                \
  return launch<TQ, T, DD, kAppend>(q, k, v, bt, lengths, chunk_lens, out,    \
                                    part, tickets, k_new, v_new, write_ok, B, \
                                    C, Hq, Hkv, page, M, P, max_splits,       \
                                    split_pages, window, s)
  PA_D(16);
  PA_D(32);
  PA_D(64);
  PA_D(128);
  PA_D(256);
#undef PA_D
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16 (the output takes q's).
// max_splits (1..8) and split_pages (>= 1): a row of n pages is cut into
// min(max_splits, ceil(n / split_pages)) splits (point 1).
// part: float32 scratch of B * Hkv * S_grid * C * (Hq / Hkv) * (D + 2)
// values and tickets: zeroed int32 of B * Hkv * ceil(C * (Hq / Hkv) / 16),
// where S_grid = min(max_splits, ceil(M / split_pages)); both unused (may
// be null) when S_grid = 1.
// k_new, v_new ([B, C, Hkv, D], the arena's dtype) and write_ok ([B] bool):
// the fused append (point 6), all three or none; null selects the kernel
// without it.  Built for q_dtype == kv_dtype and for a float32 q over a
// bf16 arena.  window: the sliding window W of point 7, 0 for none.
// The output's query slots c >= chunk_lens[b] are zeros (point 8).
// Returns cudaGetLastError() after the launch (0 = launched), or a CUDA
// error code for a refused configuration.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* bt,
                                      const void* lengths,
                                      const void* chunk_lens, void* out,
                                      void* part, void* tickets,
                                      const void* k_new, const void* v_new,
                                      const void* write_ok, int B, int C,
                                      int Hq, int Hkv, int D, int page, int M,
                                      int P, int max_splits, int split_pages,
                                      int q_dtype, int kv_dtype, int window,
                                      void* stream) {
  if (B * Hkv == 0 || C == 0 || Hq == 0) return 0;
  if (window < 0) return (int)cudaErrorInvalidValue;
  if (max_splits < 1 || max_splits > kMaxSplits || split_pages < 1)
    return (int)cudaErrorInvalidValue;
  const bool append = k_new != nullptr;
  if (append != (v_new != nullptr) || append != (write_ok != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(TQ, TKV, A)                                                 \
  return launch_d<TQ, TKV, A>(D, q, k, v, bt, lengths, chunk_lens, out, part, \
                              tickets, k_new, v_new, write_ok, B, C, Hq, Hkv, \
                              page, M, P, max_splits, split_pages, window, s)
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0) {
    if (append) PA_LAUNCH(float, float, true);
    PA_LAUNCH(float, float, false);
  }
  if (q_dtype == 0 && kv_dtype == 1) {
    if (append) PA_LAUNCH(float, bf16, true);
    PA_LAUNCH(float, bf16, false);
  }
  if (q_dtype == 1 && kv_dtype == 0 && !append) PA_LAUNCH(bf16, float, false);
  if (q_dtype == 1 && kv_dtype == 1) {
    if (append) PA_LAUNCH(bf16, bf16, true);
    PA_LAUNCH(bf16, bf16, false);
  }
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
