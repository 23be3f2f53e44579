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
// paged_attention_sharded: one launch of this kernel per shard's head slab.
//
// What bounds it on the card: bytes.  Each (row, kv head) reads every live
// K and V token of its row once, 2 * len * D elements, and does about
// 4 * C * G flops per element read: far below the ~295 flop/byte at which
// an H100's bf16 tensor cores, not its 3.35 TB/s memory, would be the limit.
// At the serving shapes (8 rows of 80-272 tokens, 16 kv heads) the whole
// launch moves ~12 MB, ~4 us at full rate, so launch ramp, the number of
// bytes in flight and the serial work per block set its time.
//
// Design, point by point (each measured on the card, PERF.md section 6):
//  1. Split-KV.  Grid (split s, kv head x query group, row b).  Split s of
//     a row takes pages [s*n/S, (s+1)*n/S) of its n = min(ceil(len/page), M)
//     pages, computed on the device from lengths[b]; the host reads no
//     length.  The partition depends on n and the split count S alone: S is
//     one constant of the wrapper (kernels/paged_attention.py::SPLITS, also
//     the grid's x), passed in as an argument instead of a template
//     parameter so that one build serves the sweep that chose it; it is
//     never derived from B, Hkv or the shard count, so every head's output
//     is bitwise the same at TP=1 and at TP=2.  S = 2: at the serving
//     shapes (rows of 80-272 tokens) each block's serial latency, not the
//     SM count, sets the time, so more splits add merge work and waves;
//     S = 2 is within 10% of S = 1 there, best on long rows, and gives
//     each TP=2 shard launch as many blocks as TP=1 has heads.  Each split writes a float32
//     partial (m, l, acc) to scratch from torch.empty; the last split of a
//     (row, head, query group) to take a ticket (threadfence, atomicAdd on a
//     zeroed int32 counter the wrapper caches per device and stream)
//     combines the S partials in the fixed order s = 0..S-1, so the result
//     does not depend on arrival order, and resets the ticket.  A split
//     with no pages contributes m = -inf, l = 0, and the merges skip it.
//     The merge issues all S loads of an output group before it uses any
//     (unrolled to kMaxSplits, float4): a loop of dependent L2 loads cost
//     ~8 us a split at C=16.  Inside a block the 4 warps split the keys
//     again (see 3) and are combined, in fixed warp order, through shared
//     memory before the split's partial is written.
//  2. Asynchronous page loads.  A ring of kStages = 2 stages in shared
//     memory (3 measured no faster at S = 2), each KT tokens of K and of V
//     in the arena's dtype (rows padded by 16 bytes, so ldmatrix reads are
//     free of bank conflicts), filled with cp.async 16 bytes at a time:
//     stage i + 1 loads while stage i computes, one __syncthreads per
//     stage.  Each token row is loaded by kThreads / KT threads that look
//     its page id up once; an unmapped page or a token past the split is
//     not fetched (cp.async zero-fills it) and its scores are masked.  The
//     query rows come in by cp.async with the first stage.  TMA is not
//     used: every tile sits behind a block-table lookup, and cp.async keeps
//     the launch free of host-built tensor maps.
//  3. Tensor cores for bf16.  When q and the arena are both bf16, each warp
//     takes one 16-row tile of the block's query slots (C*G of them: 1 at
//     decode, 16 at C=16, 64 for GQA 32:8 at C=16; padded to 16) and one
//     16-token slice of each stage, and runs S = Q.K^T and O += P.V as
//     mma.sync.m16n8k16 bf16 -> f32, fragments from ldmatrix (.trans for
//     V); P is rounded to bf16 for the P.V product, as flash attention does,
//     l sums the float32 p.  The block's 4 warps split keys (one query
//     tile: 4 slices of 16 tokens a stage, KT = 64), or query tiles (2 or
//     4 tiles: 2 or 1 slices).  wgmma is not the tool here: its 64-row tile
//     would be three quarters padding at 16 query slots; it would pay from
//     64 query slots per kv head (GQA groups of 4 or more at C=16).
//  4. float32 stays float32.  When q or the arena is float32 the same
//     split, ring, masks, online softmax and merges run with the same
//     fragment layout, but the products are CUDA-core FMAs on float32
//     values: no TF32, no bf16 rounding of q or P.
//  5. pages_per_compute_block is not used: the stage size KT is fixed by the
//     query tiling and the shared-memory budget (two blocks per SM).
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
//
// Launch: 128 threads; dynamic shared memory laid out by Layout below (the
// host sizes it with the same struct).  Head dims 16, 32, 64, 128, 256.
// The append adds no shared memory: the stage ring carries the new rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;         // query rows per warp tile, tokens per slice
constexpr int kMaxRows = 64;      // query slots per block (4 warp tiles)
constexpr int kStages = 2;        // cp.async ring depth
constexpr int kMaxSplits = 8;
constexpr int kMaxDevices = 64;
constexpr size_t kSmemBudget = 113 * 1024;  // two blocks per SM

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

// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}
__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
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
// The ring is reused, after the key loop, for the warps' partials.
struct Layout {
  int ks, qs, os;  // K/V, Q and partial-output row strides, in elements
  size_t q, lim, ok, pbuf, scale, bytes;
  __host__ __device__ Layout(int D, int t_size, int q_size, int KT, int rows,
                             int S) {
    ks = D + 16 / t_size;
    qs = D + 16 / q_size;
    os = D + 8;  // float2 stores of the mma layout: no bank conflicts
    const size_t ring = (size_t)kStages * 2 * KT * ks * t_size;
    const size_t red = (size_t)kWarps * kTile * (os + 2) * 4;
    q = align16(cmax(ring, red));
    lim = align16(q + (size_t)rows * qs * q_size);
    ok = align16(lim + (size_t)rows * 4);
    pbuf = align16(ok + (size_t)kStages * KT * 4);
    scale = align16(pbuf + (size_t)kWarps * kTile * (kTile + 1) * 4);
    bytes = align16(scale + (size_t)((S > kWarps ? S : kWarps) + 1) * rows * 4);
  }
};

template <typename TQ, typename T, int D, bool kAppend>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,         // [B, C, Hq, D]
                       const T* __restrict__ k_pages,    // [P, page, Hkv, D]
                       const T* __restrict__ v_pages,    // [P, page, Hkv, D]
                       const int* __restrict__ block_tables,  // [B, M]
                       const int* __restrict__ lengths,       // [B]
                       const int* __restrict__ chunk_lens,    // [B]
                       TQ* __restrict__ out,             // [B, C, Hq, D]
                       float* __restrict__ part,         // S > 1: partials
                       int* __restrict__ tickets,        // S > 1: zeroed
                       int C, int Hq, int Hkv, int page, int M, int P, int S,
                       int KT, int rows,
                       const T* __restrict__ k_new,      // kAppend: [B, C, Hkv, D]
                       const T* __restrict__ v_new,      // kAppend: [B, C, Hkv, D]
                       const uint8_t* __restrict__ write_ok) {  // kAppend: [B]
  constexpr bool kMma =
      sizeof(TQ) == 2 && sizeof(T) == 2;  // both bf16: tensor cores
  using QS = typename std::conditional<kMma, __nv_bfloat16, float>::type;
  constexpr int NT = D / 8;   // 8-column output tiles per query row
  constexpr int D4 = D / 4;   // float4 groups per query row

  const int G = Hq / Hkv;
  const int NQ = C * G;  // query slot qi = c * G + g  <->  head h * G + g
  const int NQG = (NQ + kMaxRows - 1) / kMaxRows;
  const int s = blockIdx.x;
  const int h = blockIdx.y / NQG, qg = blockIdx.y % NQG;
  const int b = blockIdx.z;
  const int q0 = qg * kMaxRows;
  const int nrow = min(kMaxRows, NQ - q0);
  const int NQT = (nrow + kTile - 1) / kTile;  // 16-row query tiles
  const int WQ = NQT == 1 ? 1 : (NQT == 2 ? 2 : 4);
  const int slices = KT / kTile;  // 16-token slices per stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = warp / (kWarps / WQ), kg = warp % (kWarps / WQ);
  const bool active = qt < NQT && kg < slices;

  const Layout L(D, sizeof(T), sizeof(QS), KT, rows, S);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][2][KT][ks]
  QS* q_s = reinterpret_cast<QS*>(smem + L.q);       // [rows][qs]
  int* lim_s = reinterpret_cast<int*>(smem + L.lim);  // [rows]
  int* ok_s = reinterpret_cast<int*>(smem + L.ok);    // [kStages][KT]
  float* p_s = reinterpret_cast<float*>(smem + L.pbuf) +
               warp * kTile * (kTile + 1);            // [16][17], f32 path
  float* sc_s = reinterpret_cast<float*>(smem + L.scale);  // merge scales
  float* l_tot = sc_s + (size_t)(S > kWarps ? S : kWarps) * rows;  // [rows]
  __shared__ int is_last;

  const int len = lengths[b];
  const int cl = chunk_lens[b];
  int n_pages = len > 0 ? (len + page - 1) / page : 0;
  if (n_pages > M) n_pages = M;
  const int t0 = (s * n_pages) / S * page;
  const int t1 = min((s + 1) * n_pages / S * page, len);
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
  // row loaded by kThreads / KT threads that look its page id up once;
  // tokens past the split and unmapped pages are zero-filled, not read
  constexpr int CPT = D * (int)sizeof(T) / 16;  // chunks per token row
  constexpr int EPC = 16 / (int)sizeof(T);      // elements per chunk
  const int tpt = kThreads / KT;                // threads per token row
  const int my_row = tid / tpt, my_c0 = tid % tpt;
  auto load_stage = [&](int st) {
    const int buf = st % kStages;
    T* k_dst = ring + (size_t)buf * 2 * KT * L.ks + (size_t)my_row * L.ks;
    T* v_dst = k_dst + (size_t)KT * L.ks;
    const int t = t0 + st * KT + my_row;
    int pid = -1;
    bool mine = false;  // a token this launch appends
    if (t < t1) {
      pid = block_tables[(long long)b * M + t / page];
      mine = fresh(t, pid);
      if (pid >= P) pid = P - 1;  // the reference's gathers clamp
    }
    const bool live = pid >= 0;
    const long long off =
        live ? (long long)pid * page_stride + ((long long)(t % page) * Hkv + h) * D
             : 0;
    const T* k_src = k_pages + off;
    const T* v_src = v_pages + off;
    if constexpr (kAppend) {
      if (mine) {
        const long long n = (((long long)b * C + (t - t_new)) * Hkv + h) * D;
        k_src = k_new + n;
        v_src = v_new + n;
      }
    }
    for (int c = my_c0; c < CPT; c += tpt) {
      cp_async16(k_dst + c * EPC, k_src + c * EPC, live ? 16 : 0);
      cp_async16(v_dst + c * EPC, v_src + c * EPC, live ? 16 : 0);
    }
    if (my_c0 == 0) ok_s[buf * KT + my_row] = live;
  };

  // append mode, once stage st has landed: the chunks this thread loaded
  // of a token the launch appends go from the ring to the arena (its own
  // cp.async writes are visible to it after the wait; the ring slot is
  // refilled only after the next __syncthreads).  Query group 0 writes.
  auto store_stage = [&](int st) {
    const int t = t0 + st * KT + my_row;
    if (t >= t1 || qg != 0) return;
    const int pid = block_tables[(long long)b * M + t / page];
    if (!fresh(t, pid)) return;
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

  // stage the block's query rows (padding rows are zeros and see nothing):
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
      // query slot c sits at global position len - cl + c and sees
      // positions below that + 1; padded slots (c >= cl) see pos < len
      const int c = (q0 + r) / G;
      lim = min(len - cl + c + 1, len);
    }
    lim_s[r] = lim;
  }

  // per-thread state: rows r0 = lane/4 and r0 + 8 of the warp's query tile,
  // output columns nt*8 + (lane%4)*2 + {0,1} (the mma accumulator layout)
  const int r0 = lane >> 2;
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.f, 0.f};

  // the ring: a group is committed per stage slot, loaded or not, so that
  // wait_group(kStages - 2) always means "the oldest stage has landed"
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_stages) load_stage(i);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    if constexpr (kAppend) store_stage(st);
    __syncthreads();
    if (st + kStages - 1 < n_stages) load_stage(st + kStages - 1);
    cp_async_commit();

    const int buf = st % kStages;
    const int tt = t0 + st * KT + kg * kTile;  // first token of the slice
    if (!active || tt >= t1) continue;         // (warp-uniform)
    const T* k_sl = ring + (size_t)buf * 2 * KT * L.ks + (size_t)kg * kTile * L.ks;
    const T* v_sl = k_sl + (size_t)KT * L.ks;
    const QS* q_t = q_s + (size_t)qt * kTile * L.qs;
    const int* ok_sl = ok_s + buf * KT + kg * kTile;

    // scores of the tile: sc[nt][0..1] row r0, sc[nt][2..3] row r0 + 8,
    // keys nt*8 + (lane%4)*2 + {0,1}
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (kMma) {
      const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], kb[4];
        ldsm_x4(a, q_t + (size_t)((mi & 1) * 8 + mr) * L.qs + kk * 16 + (mi >> 1) * 8);
        ldsm_x4(kb, k_sl + (size_t)((mi >> 1) * 8 + mr) * L.ks + kk * 16 + (mi & 1) * 8);
        mma_bf16(sc[0], a, kb[0], kb[1]);
        mma_bf16(sc[1], a, kb[2], kb[3]);
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
            const float2 kv =
                load2(k_sl + (size_t)(nt * 8 + (lane & 3) * 2 + e) * L.ks + d);
            sc[nt][e] = fmaf(xa.y, kv.y, fmaf(xa.x, kv.x, sc[nt][e]));
            sc[nt][2 + e] = fmaf(xb.y, kv.y, fmaf(xb.x, kv.x, sc[nt][2 + e]));
          }
      }
    }

    // mask, then the online-softmax update of rows r0 and r0 + 8
    const int lim0 = lim_s[qt * kTile + r0], lim1 = lim_s[qt * kTile + r0 + 8];
    bool live[2][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = nt * 8 + (lane & 3) * 2 + e;
        const bool ok = ok_sl[key] != 0;
        live[nt][e] = ok && tt + key < lim0;
        live[nt][2 + e] = ok && tt + key < lim1;
        sc[nt][e] = live[nt][e] ? sc[nt][e] * scale : -INFINITY;
        sc[nt][2 + e] = live[nt][2 + e] ? sc[nt][2 + e] * scale : -INFINITY;
        mx[0] = fmaxf(mx[0], sc[nt][e]);
        mx[1] = fmaxf(mx[1], sc[nt][2 + e]);
      }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_row[i], mx[i]);
      m_safe[i] = isfinite(m_new) ? m_new : 0.f;
      alpha[i] = isfinite(m_row[i]) ? expf(m_row[i] - m_safe[i]) : 0.f;
      m_row[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1;
        const float p = live[nt][j] ? expf(sc[nt][j] - m_safe[i]) : 0.f;
        sc[nt][j] = p;
        sum[i] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * alpha[i] + sum[i];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // o += P . V
    if constexpr (kMma) {
      uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                        pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
      const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, v_sl + (size_t)((mi & 1) * 8 + mr) * L.ks + dp * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = nt * 8 + (lane & 3) * 2 + e;
          p_s[r0 * (kTile + 1) + key] = sc[nt][e];
          p_s[(r0 + 8) * (kTile + 1) + key] = sc[nt][2 + e];
        }
      __syncwarp();
#pragma unroll 2
      for (int key = 0; key < kTile; ++key) {
        const float pa = p_s[r0 * (kTile + 1) + key];
        const float pb = p_s[(r0 + 8) * (kTile + 1) + key];
        const T* vr = v_sl + (size_t)key * L.ks + (lane & 3) * 2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 v = load2(vr + nt * 8);
          o[nt][0] = fmaf(pa, v.x, o[nt][0]);
          o[nt][1] = fmaf(pa, v.y, o[nt][1]);
          o[nt][2] = fmaf(pb, v.x, o[nt][2]);
          o[nt][3] = fmaf(pb, v.y, o[nt][3]);
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
  }
  __syncthreads();  // the ring is free: it now holds the warps' partials

  float* red_o = reinterpret_cast<float*>(smem);  // [kWarps][16][os]
  float* red_m = red_o + kWarps * kTile * L.os;    // [kWarps][16]
  float* red_l = red_m + kWarps * kTile;           // [kWarps][16]
  if (active) {
    float* ow = red_o + (size_t)warp * kTile * L.os;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(ow + r0 * L.os + col) = make_float2(o[nt][0], o[nt][1]);
      *reinterpret_cast<float2*>(ow + (r0 + 8) * L.os + col) =
          make_float2(o[nt][2], o[nt][3]);
    }
    if ((lane & 3) == 0) {
      red_m[warp * kTile + r0] = m_row[0];
      red_l[warp * kTile + r0] = l_row[0];
      red_m[warp * kTile + r0 + 8] = m_row[1];
      red_l[warp * kTile + r0 + 8] = l_row[1];
    }
  }
  __syncthreads();

  // combine the warps that share a query tile, in fixed warp order
  const int wk = kWarps / WQ;  // warps per query tile
  const int nk = min(wk, slices);
  const long long n_rows = (long long)gridDim.z * Hkv * S * NQ;  // partials
  const long long base = ((long long)(b * Hkv + h) * S) * NQ + q0;
  for (int r = tid; r < nrow; r += kThreads) {
    const int w0 = (r / kTile) * wk, rr = r % kTile;
    float m = -INFINITY;
    for (int j = 0; j < nk; ++j) m = fmaxf(m, red_m[(w0 + j) * kTile + rr]);
    const float ms = isfinite(m) ? m : 0.f;
    float l = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float mj = red_m[(w0 + j) * kTile + rr];
      const float f = isfinite(mj) ? expf(mj - ms) : 0.f;
      sc_s[j * rows + r] = f;
      l += red_l[(w0 + j) * kTile + rr] * f;
    }
    l_tot[r] = l;
    if (S > 1) {
      part[n_rows * D + base + (long long)s * NQ + r] = m;
      part[n_rows * (D + 1) + base + (long long)s * NQ + r] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < nrow * D4; i += kThreads) {
    const int r = i / D4, d = (i - (i / D4) * D4) * 4;
    const int w0 = (r / kTile) * wk, rr = r % kTile;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < nk; ++j) {
      const float f = sc_s[j * rows + r];
      if (f != 0.f)
        acc = fma4(f, *reinterpret_cast<const float4*>(
                          red_o + ((size_t)(w0 + j) * kTile + rr) * L.os + d),
                   acc);
    }
    if (S == 1) {
      const int qi = q0 + r, c = qi / G, g = qi - (qi / G) * G;
      const float inv = 1.f / fmaxf(l_tot[r], 1e-30f);
      store4(out + (((long long)b * C + c) * Hq + (long long)h * G + g) * D + d,
             make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    } else {
      store4(part + (base + (long long)s * NQ + r) * D + d, acc);
    }
  }
  if (S == 1) return;

  // ticket: the last split of this (row, head, query group) to arrive
  // merges all S partials in the order s = 0..S-1
  __threadfence();
  __syncthreads();
  int* ticket = tickets + ((long long)b * Hkv + h) * NQG + qg;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
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
        sc_s[j * rows + r] = f;
        l += lj[j] * f;
      }
    l_tot[r] = l;
  }
  __syncthreads();
  for (int i = tid; i < nrow * D4; i += kThreads) {
    const int r = i / D4, d = (i - (i / D4) * D4) * 4;
    float4 x[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)  // every load issued before use
      if (j < S && sc_s[j * rows + r] != 0.f)
        x[j] = __ldcg(reinterpret_cast<const float4*>(
            part + (base + (long long)j * NQ + r) * D + d));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < S && sc_s[j * rows + r] != 0.f) acc = fma4(sc_s[j * rows + r], x[j], acc);
    const int qi = q0 + r, c = qi / G, g = qi - (qi / G) * G;
    const float inv = 1.f / fmaxf(l_tot[r], 1e-30f);
    store4(out + (((long long)b * C + c) * Hq + (long long)h * G + g) * D + d,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

template <typename TQ, typename T, int D, bool kAppend>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* lengths, const void* chunk_lens, void* out, void* part,
           void* tickets, const void* k_new, const void* v_new,
           const void* write_ok, int B, int C, int Hq, int Hkv, int page,
           int M, int P, int S, cudaStream_t stream) {
  constexpr bool kMma = sizeof(TQ) == 2 && sizeof(T) == 2;
  const int q_size = kMma ? 2 : 4;
  const int NQ = C * (Hq / Hkv);
  const int NQG = (NQ + kMaxRows - 1) / kMaxRows;
  const int rows = ((NQ < kMaxRows ? NQ : kMaxRows) + kTile - 1) / kTile * kTile;
  const int NQT = rows / kTile;
  const int WQ = NQT == 1 ? 1 : (NQT == 2 ? 2 : 4);
  int KT = kTile * (kWarps / WQ);
  while (KT > kTile &&
         Layout(D, sizeof(T), q_size, KT, rows, S).bytes > kSmemBudget)
    KT /= 2;
  const size_t bytes = Layout(D, sizeof(T), q_size, KT, rows, S).bytes;
  // the device's opt-in limit and the attribute already set, per device
  static int cap[kMaxDevices], set[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cap[dev] == 0)
    cudaDeviceGetAttribute(&cap[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)cap[dev]) return (int)cudaErrorInvalidValue;
  if ((int)bytes > set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, T, D, kAppend>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    set[dev] = (int)bytes;
  }
  const dim3 grid(S, Hkv * NQG, B);
  paged_attention_kernel<TQ, T, D, kAppend><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<const int*>(chunk_lens),
      static_cast<TQ*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), C, Hq, Hkv, page, M, P, S, KT, rows,
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const uint8_t*>(write_ok));
  return (int)cudaGetLastError();
}

template <typename TQ, typename T, bool kAppend>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* bt, const void* lengths, const void* chunk_lens,
             void* out, void* part, void* tickets, const void* k_new,
             const void* v_new, const void* write_ok, int B, int C, int Hq,
             int Hkv, int page, int M, int P, int S, cudaStream_t s) {
#define PA_D(DD)                                                              \
  if (D == DD)                                                                \
  return launch<TQ, T, DD, kAppend>(q, k, v, bt, lengths, chunk_lens, out,    \
                                    part, tickets, k_new, v_new, write_ok, B, \
                                    C, Hq, Hkv, page, M, P, S, s)
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
// S: the split count (1..8).
// part: float32 scratch of B * Hkv * S * C * (Hq / Hkv) * (D + 2) values and
// tickets: zeroed int32 of B * Hkv * ceil(C * (Hq / Hkv) / 64), both unused
// (may be null) when S = 1.
// k_new, v_new ([B, C, Hkv, D], the arena's dtype) and write_ok ([B] bool):
// the fused append (point 6), all three or none; null selects the kernel
// without it.  Built for q_dtype == kv_dtype and for a float32 q over a
// bf16 arena.  Returns cudaGetLastError() after the launch (0 = launched),
// or a CUDA error code for a refused configuration.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* bt,
                                      const void* lengths,
                                      const void* chunk_lens, void* out,
                                      void* part, void* tickets,
                                      const void* k_new, const void* v_new,
                                      const void* write_ok, int B, int C,
                                      int Hq, int Hkv, int D, int page, int M,
                                      int P, int S, int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B * Hkv == 0 || C == 0 || Hq == 0) return 0;
  if (S < 1 || S > kMaxSplits ||
      (S > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool append = k_new != nullptr;
  if (append != (v_new != nullptr) || append != (write_ok != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(TQ, TKV, A)                                                 \
  return launch_d<TQ, TKV, A>(D, q, k, v, bt, lengths, chunk_lens, out, part, \
                              tickets, k_new, v_new, write_ok, B, C, Hq, Hkv, \
                              page, M, P, S, s)
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
