// In-place KV page write for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_kv.py::kv_write_pallas (kernel body
// _kv_write_kernel). Row b's chunk token t (t < valid_len[b]) lands in
// every layer's pool at page table[b, (start[b]+t) / PS], page row
// (start[b]+t) % PS. Tokens whose page is the garbage page 0, or whose
// page index falls outside the table, are dropped.
//
// What bounds it on this card: bytes, and nothing else. It does no
// arithmetic: each written token row is read once from the chunk and
// written once into the pool (2 * L * KVH*Dh * 2 bytes per token for K
// and V, read plus write).
//
// What the design does about it: a per-token scatter. One block per
// (row, token) resolves its page once and then copies that token's
// KVH*Dh row for every layer with 16-byte loads and stores, so every
// byte moves exactly once and no page is read back. The TPU kernel's
// page read-modify-write existed only for its 8-row tiling; Hopper
// writes single rows natively.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) kv_write_kernel(
    uint4* __restrict__ k_pages,        // [L, NP, PS, KD] as 16-byte chunks
    uint4* __restrict__ v_pages,
    const uint4* __restrict__ k_new,    // [L, B, Tb, KD]
    const uint4* __restrict__ v_new,
    const int32_t* __restrict__ table,  // [B, MP]
    const int32_t* __restrict__ start,  // [B]
    const int32_t* __restrict__ valid_len,  // [B]
    int L, int NP, int PS, int KD, int B, int Tb, int MP)
{
  const int t = blockIdx.x, b = blockIdx.y;
  if (t >= valid_len[b]) return;
  const int pos = start[b] + t;
  const int pi = pos / PS;
  if (pos < 0 || pi >= MP) return;
  const int page = table[static_cast<size_t>(b) * MP + pi];
  if (page <= 0 || page >= NP) return;
  const int row = pos % PS;
  const int vec = KD / 8;
  for (int l = 0; l < L; ++l) {
    const size_t src = ((static_cast<size_t>(l) * B + b) * Tb + t) * vec;
    const size_t dst = ((static_cast<size_t>(l) * NP + page) * PS + row) * vec;
    for (int i = threadIdx.x; i < vec; i += THREADS) {
      k_pages[dst + i] = k_new[src + i];
      v_pages[dst + i] = v_new[src + i];
    }
  }
}

}  // namespace

extern "C" int kv_write_bf16(
    void* k_pages, void* v_pages, const void* k_new, const void* v_new,
    const void* table, const void* start, const void* valid_len,
    int L, int NP, int PS, int KD, int B, int Tb, int MP, void* stream)
{
  kv_write_kernel<<<dim3(Tb, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(valid_len), L, NP, PS, KD, B, Tb, MP);
  return static_cast<int>(cudaGetLastError());
}
