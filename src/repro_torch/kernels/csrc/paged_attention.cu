// Paged attention over the versioned KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention_pallas (body _kernel): flash-style online-softmax
// attention of C query tokens per row over the row's KV pages, found
// through the block table, with GQA (G = Hq / Hkv query heads per KV
// head), the in-chunk causal mask from lengths / chunk_lens, -1 (unmapped)
// pages masked, float32 m / l / acc, and rows of length 0 giving zeros.
//
// What bounds it on the card: bytes.  Each (row, kv head) reads every live
// K and V token of its row once, 2 * len * D elements, and does about
// 4 * C * G FLOPs per element read -- far below the ~295 FLOP/byte at which
// an H100's bf16 tensor cores, not its 3.35 TB/s memory, would be the limit.
//
// What this simple design does about that:
//  - one thread block per (row b, kv head h); the G x C queries of that
//    KV head share every K/V tile the block stages in shared memory, so a
//    token's K and V cross device memory once per block, not once per query;
//  - the block loops over its row's pages only up to ceil(lengths[b] / page),
//    reading lengths on the device (the host never reads a length to size
//    the launch), and it never reads a -1 page at all (the Pallas version
//    still issues the DMA for skipped blocks);
//  - pages_per_compute_block (ppcb) pages form one tile of ppcb * page
//    tokens; results do not depend on it beyond float32 rounding.
// Not yet done (later work): tensor cores (wgmma), TMA loads, split-KV
// across blocks for long rows, and more than one block in flight per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kThreads = 128;

// Shared-memory layout, in 4-byte words, shared by the kernel and the host.
struct Smem {
  int T, KS, D, NQ, ppcb;
  __host__ __device__ Smem(int page, int ppcb_, int D_, int NQ_)
      : T(ppcb_ * page), KS(D_ + 1), D(D_), NQ(NQ_), ppcb(ppcb_) {}
  __host__ __device__ long long words() const {
    return (long long)T * KS + (long long)T * D + 2LL * NQ * D +
           (long long)NQ * T + 4LL * NQ + ppcb;
  }
};

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,         // [B, C, Hq, D]
                       const T* __restrict__ k_pages,    // [P, page, Hkv, D]
                       const T* __restrict__ v_pages,    // [P, page, Hkv, D]
                       const int* __restrict__ block_tables,  // [B, M]
                       const int* __restrict__ lengths,       // [B]
                       const int* __restrict__ chunk_lens,    // [B]
                       TQ* __restrict__ out,             // [B, C, Hq, D]
                       int C, int Hq, int Hkv, int D, int page, int M, int P,
                       int ppcb) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int NQ = C * G;  // query slot qi = c * G + g  <->  head h * G + g
  const Smem L(page, ppcb, D, NQ);
  const int TT = L.T;

  extern __shared__ float smem[];
  float* k_s = smem;                          // [TT][D + 1]
  float* v_s = k_s + (long long)TT * L.KS;    // [TT][D]
  float* q_s = v_s + (long long)TT * D;       // [NQ][D]
  float* acc_s = q_s + (long long)NQ * D;     // [NQ][D]
  float* s_s = acc_s + (long long)NQ * D;     // [NQ][TT] scores, then probs
  float* m_s = s_s + (long long)NQ * TT;      // [NQ] running max
  float* l_s = m_s + NQ;                      // [NQ] running denominator
  float* a_s = l_s + NQ;                      // [NQ] this tile's rescale
  int* lim_s = reinterpret_cast<int*>(a_s + NQ);  // [NQ] causal horizon
  int* map_s = lim_s + NQ;                        // [ppcb] tile page ids

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;
  const int len = lengths[b];
  const int cl = chunk_lens[b];
  const float scale = 1.0f / sqrtf((float)D);

  for (int i = tid; i < NQ * D; i += kThreads) {
    const int qi = i / D, d = i - (i / D) * D;
    const int c = qi / G, g = qi - (qi / G) * G;
    const long long off =
        (((long long)b * C + c) * Hq + (long long)h * G + g) * D + d;
    q_s[i] = to_f<TQ>(q[off]);
    acc_s[i] = 0.f;
  }
  for (int qi = tid; qi < NQ; qi += kThreads) {
    m_s[qi] = -INFINITY;
    l_s[qi] = 0.f;
    // query slot c sits at global position len - cl + c and sees positions
    // below that + 1; padded slots (c >= cl) see the full pos < len view
    const int qpos = len - cl + qi / G;
    lim_s[qi] = min(qpos + 1, len);
  }
  int n_pages = len > 0 ? (len + page - 1) / page : 0;
  if (n_pages > M) n_pages = M;
  const int n_tiles = (n_pages + ppcb - 1) / ppcb;
  const long long page_stride = (long long)page * Hkv * D;
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int start = tile * TT;
    if (tid < ppcb) {
      const int pi = tile * ppcb + tid;
      int pid = -1;
      if (pi < n_pages) {
        pid = block_tables[(long long)b * M + pi];
        if (pid >= P) pid = P - 1;  // the reference's gathers clamp
      }
      map_s[tid] = pid;
    }
    __syncthreads();

    // stage the tile's K and V in float32; unmapped pages are not read and
    // stage as zeros (their scores are masked, and 0 * garbage could be NaN)
    for (int i = tid; i < TT * D; i += kThreads) {
      const int t = i / D, d = i - (i / D) * D;
      const int pid = map_s[t / page];
      float kf = 0.f, vf = 0.f;
      if (pid >= 0) {
        const long long off = (long long)pid * page_stride +
                              ((long long)(t % page) * Hkv + h) * D + d;
        kf = to_f<T>(k_pages[off]);
        vf = to_f<T>(v_pages[off]);
      }
      k_s[(long long)t * L.KS + d] = kf;
      v_s[(long long)t * D + d] = vf;
    }
    __syncthreads();

    // scores: one (query, token) pair per thread
    for (int i = tid; i < NQ * TT; i += kThreads) {
      const int qi = i / TT, t = i - (i / TT) * TT;
      float sc = -INFINITY;
      if (map_s[t / page] >= 0 && start + t < lim_s[qi]) {
        const float* qr = q_s + (long long)qi * D;
        const float* kr = k_s + (long long)t * L.KS;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      s_s[i] = sc;
    }
    __syncthreads();

    // online softmax: one warp per query slot
    for (int qi = warp; qi < NQ; qi += nwarps) {
      float* sr = s_s + (long long)qi * TT;
      float mx = -INFINITY;
      for (int t = lane; t < TT; t += 32) mx = fmaxf(mx, sr[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int t = lane; t < TT; t += 32) {
        const float sv = sr[t];
        const float p = isfinite(sv) ? expf(sv - m_safe) : 0.f;
        sr[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        a_s[qi] = alpha;
        l_s[qi] = l_s[qi] * alpha + sum;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V: one (query, dim) pair per thread
    for (int i = tid; i < NQ * D; i += kThreads) {
      const int qi = i / D, d = i - (i / D) * D;
      const float* pr = s_s + (long long)qi * TT;
      float a = acc_s[i] * a_s[qi];
      for (int t = 0; t < TT; ++t) a = fmaf(pr[t], v_s[(long long)t * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < NQ * D; i += kThreads) {
    const int qi = i / D, d = i - (i / D) * D;
    const int c = qi / G, g = qi - (qi / G) * G;
    const long long off =
        (((long long)b * C + c) * Hq + (long long)h * G + g) * D + d;
    out[off] = from_f<TQ>(acc_s[i] / fmaxf(l_s[qi], 1e-30f));
  }
}

template <typename TQ, typename T>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* lengths, const void* chunk_lens, void* out, int B,
           int C, int Hq, int Hkv, int D, int page, int M, int P, int ppcb,
           cudaStream_t stream) {
  const Smem L(page, ppcb, D, C * (Hq / Hkv));
  const size_t bytes = (size_t)L.words() * 4;
  int dev = 0, cap = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)cap) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<TQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<TQ, T><<<B * Hkv, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<const int*>(chunk_lens),
      static_cast<TQ*>(out), C, Hq, Hkv, D, page, M, P, ppcb);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16 (the output takes q's).
// Returns cudaGetLastError() after the launch (0 = launched), or a CUDA
// error code for a refused configuration.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* bt,
                                      const void* lengths,
                                      const void* chunk_lens, void* out,
                                      int B, int C, int Hq, int Hkv, int D,
                                      int page, int M, int P, int ppcb,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B * Hkv == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(TQ, TKV)                                                   \
  return launch<TQ, TKV>(q, k, v, bt, lengths, chunk_lens, out, B, C, Hq, Hkv, \
                         D, page, M, P, ppcb, s)
  if (q_dtype == 0 && kv_dtype == 0) PA_LAUNCH(float, float);
  if (q_dtype == 0 && kv_dtype == 1) PA_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) PA_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
