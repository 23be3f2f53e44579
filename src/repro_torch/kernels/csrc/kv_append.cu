// Paged KV append, C tokens per row, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kv_append.py::kv_append_pallas
// (body _kernel) in its C-token form, which is exactly the masked scatter
// the JAX serving step does with jnp (src/repro/serving/paged_decode.py,
// _chunk_core): token j of row b lands in slot (lengths[b] + j) % page of
// page block_tables[b, (lengths[b] + j) / page], and is skipped when
// j >= n_new[b], the page is -1 (or past the arena), the page slot is past
// the block table's width M, or write_ok[b] is false.  At C = 1 with every
// row live it is kv_append_pallas.
//
// What bounds it: bytes -- each live token's K and V row (Hkv * D
// elements) is read once and written once; there is no arithmetic.  The
// design: one thread block per (row, token), threads copying the row in
// 16-byte units where the row allows it (2-byte units otherwise), so the
// copy is coalesced and dtype-agnostic (the bits are moved, never
// converted: bit-exact by construction).  Masked tokens return before
// touching memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename U>
__global__ void __launch_bounds__(kThreads)
kv_append_kernel(const U* __restrict__ k_new,     // [B, C, row]
                 const U* __restrict__ v_new,     // [B, C, row]
                 const int* __restrict__ n_new,   // [B]
                 const uint8_t* __restrict__ write_ok,  // [B] bool
                 const int* __restrict__ block_tables,  // [B, M]
                 const int* __restrict__ lengths,       // [B]
                 U* __restrict__ k_pages,         // [P, page, row]
                 U* __restrict__ v_pages,         // [P, page, row]
                 int C, int M, int P, int page, int row_units) {
  const int b = blockIdx.x / C;
  const int j = blockIdx.x - b * C;
  if (j >= n_new[b] || !write_ok[b]) return;
  const int pos = lengths[b] + j;
  const int pos_page = pos / page;
  if (pos_page >= M) return;
  const int pid = block_tables[(long long)b * M + pos_page];
  if (pid < 0 || pid >= P) return;
  const long long dst = ((long long)pid * page + pos % page) * row_units;
  const long long src = ((long long)b * C + j) * row_units;
  for (int u = threadIdx.x; u < row_units; u += kThreads) {
    k_pages[dst + u] = k_new[src + u];
    v_pages[dst + u] = v_new[src + u];
  }
}

}  // namespace

// row_bytes = Hkv * D * element size.  Returns cudaGetLastError() after the
// launch (0 = launched), or a CUDA error code for a refused configuration.
extern "C" int kv_append_launch(const void* k_new, const void* v_new,
                                const void* n_new, const void* write_ok,
                                const void* bt, const void* lengths,
                                void* k_pages, void* v_pages, int B, int C,
                                int M, int P, int page, int row_bytes,
                                void* stream) {
  if (B * C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(k_new) | reinterpret_cast<uintptr_t>(v_new) |
      reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages);
  if (row_bytes % 16 == 0 && align % 16 == 0) {
    kv_append_kernel<uint4><<<B * C, kThreads, 0, s>>>(
        static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
        static_cast<const int*>(n_new), static_cast<const uint8_t*>(write_ok),
        static_cast<const int*>(bt), static_cast<const int*>(lengths),
        static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages), C, M, P,
        page, row_bytes / 16);
  } else if (row_bytes % 2 == 0 && align % 2 == 0) {
    kv_append_kernel<uint16_t><<<B * C, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new),
        static_cast<const int*>(n_new), static_cast<const uint8_t*>(write_ok),
        static_cast<const int*>(bt), static_cast<const int*>(lengths),
        static_cast<uint16_t*>(k_pages), static_cast<uint16_t*>(v_pages), C, M,
        P, page, row_bytes / 2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
