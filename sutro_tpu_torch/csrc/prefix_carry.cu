// Shared-prefix attention carry for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_paged.py::prefix_attention_carry_pallas
// (kernel body _prefix_carry_kernel). Every row's decode query attends
// over one job-shared, page-aligned prefix; the result is the
// online-softmax carry (m, l, acc) that the paged-decode kernel starts
// from (its carry option), so the shared pages are read from device
// memory once per layer-step for the whole batch instead of once per
// row. Per-row length mask (pfx_len) and sliding window (q_pos - t <
// window); a row outside the group (pfx_len 0) gets the cold carry
// (-1e30, 0, 0). Outputs are per head: m/l [B, NH] f32, acc [B, NH, Dh]
// f32 (the TPU kernel's block-diagonal [B, NH, KVH*Dh] acc existed only
// for its 128-lane matrix unit).
//
// What bounds it on this card: operations. For one KV head the B*G
// queries against the prefix's tokens are two matrix products,
// S = Q K^T and P V (4 * B*G * Lp * Dh flops), against one read of the
// prefix's K/V rows.
//
// What the design does about it: the B*G query rows of one KV head form
// the M side of a tensor-core product (nvcuda::wmma 16x16x16 bf16, f32
// accumulate): one block per (KV head, 64 query rows, split of the
// prefix) loads each 64-token tile of the shared pages into shared
// memory once and uses it for all 64 rows. Each warp owns 16 rows: its
// scores, the f32 online softmax (p taken under the mask, so an
// all-masked tile adds 0) and its accumulator rows, so warps sync only
// around the shared K/V tile. P V takes p as two bf16 terms, p_hi =
// bf16(p) and p_lo = bf16(p - p_hi), so the carry keeps ~16 bits of p
// as the reference's f32 p does (one bf16 p is off by up to 2^-8,
// which over a 1,024-token prefix exceeds the 2e-2 check on acc).
// Tiles at or past the block's longest pfx_len are never read: the
// padding pages (page 0) are masked by length, not trusted. With few KV
// heads the (head, query tile) grid is small (qwen3-30b-a3b: 4 x 8 = 32
// blocks on 132 SMs), so the wrapper splits the prefix's tiles over
// blocks and a second small kernel combines the partial carries by
// max/rescale/sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int QT = 64;        // query rows per block
constexpr int TT = 64;        // prefix tokens per tile

template <int DH>
struct Smem {
  static constexpr int LDQ = DH + 8;   // bf16 rows (Q, K, V)
  static constexpr int LDS = TT + 4;   // f32 score rows
  static constexpr int LDP = TT + 8;   // bf16 probability rows
  static constexpr int LDA = DH + 4;   // f32 accumulator rows
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(QT) * LDQ * 2;
  static constexpr size_t v = k + size_t(TT) * LDQ * 2;
  static constexpr size_t s = v + size_t(TT) * LDQ * 2;
  static constexpr size_t p = s + size_t(QT) * LDS * 4;
  static constexpr size_t p_lo = p + size_t(QT) * LDP * 2;
  static constexpr size_t acc = p_lo + size_t(QT) * LDP * 2;
  static constexpr size_t ml = acc + size_t(QT) * LDA * 4;  // m, l per row
  static constexpr size_t bytes = ml + size_t(QT) * 2 * 4;
};

template <int DH>
__global__ void __launch_bounds__(THREADS) prefix_carry_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, NH, DH]
    const __nv_bfloat16* __restrict__ k_pages,  // [NP, PS, KVH*DH]
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ pfx_pages,      // [Pp]
    const int32_t* __restrict__ pfx_len,        // [B]
    const int32_t* __restrict__ q_pos,          // [B]
    float* __restrict__ m_out,                  // [S, B, NH]
    float* __restrict__ l_out,
    float* __restrict__ acc_out,                // [S, B, NH, DH]
    int B, int NH, int KVH, int PS, int Pp, int window, int tiles_per_split,
    float scale)
{
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  __nv_bfloat16* plo_s = reinterpret_cast<__nv_bfloat16*>(smem + L::p_lo);
  float* a_s = reinterpret_cast<float*>(smem + L::acc);
  float* m_s = reinterpret_cast<float*>(smem + L::ml);
  float* l_s = m_s + QT;
  __shared__ int max_len_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, split = blockIdx.z;
  const int G = NH / KVH, BG = B * G, KD = KVH * DH;
  const int r0 = blockIdx.y * QT;  // first query row (b * G + g) of the block
  constexpr int VEC = DH / 8;      // 16-byte chunks per row

  // query tile (rows past B*G are zero) and the block's longest prefix
  for (int c = tid; c < QT * VEC; c += THREADS) {
    const int r = c / VEC, col = c % VEC, row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < BG) {
      const int b = row / G, n = h * G + row % G;
      val = reinterpret_cast<const uint4*>(q + (static_cast<size_t>(b) * NH + n) * DH)[col];
    }
    *reinterpret_cast<uint4*>(q_s + r * L::LDQ + col * 8) = val;
  }
  for (int i = tid; i < QT * L::LDA; i += THREADS) a_s[i] = 0.f;
  if (tid < QT) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }
  if (tid == 0) max_len_s = 0;
  __syncthreads();
  if (tid < QT && r0 + tid < BG) atomicMax(&max_len_s, pfx_len[(r0 + tid) / G]);
  __syncthreads();

  const int Lp = Pp * PS;
  const int len_hi = min(max_len_s, Lp);
  const int t_begin = split * tiles_per_split * TT;
  const int t_end = min(len_hi, t_begin + tiles_per_split * TT);

  // this warp's 16 rows; in the softmax a lane pair owns one row (each
  // lane half of the tile's columns), with the row's length and window
  // origin held in registers
  const int my_r = warp * 16;
  const int sm_r = my_r + lane / 2, half = lane % 2;
  int len = 0, pos = 0;
  if (r0 + sm_r < BG) {
    len = pfx_len[(r0 + sm_r) / G];
    pos = q_pos[(r0 + sm_r) / G];
  }
  static_assert(TT == 64, "the softmax gives each lane of a pair 32 columns");
  constexpr int LOADS = TT * VEC / THREADS;  // 16-byte chunks per thread and tile
  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    const int n = min(TT, t_end - t0);
    // 1. the tile's K/V rows of head h (rows >= n are zero): every load
    //    is started before the first store
    {
      uint4 kr[LOADS], vr[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = tid + i * THREADS, r = c / VEC, col = c % VEC;
        kr[i] = make_uint4(0, 0, 0, 0);
        vr[i] = make_uint4(0, 0, 0, 0);
        if (r < n) {
          const int t = t0 + r;
          const size_t at =
              (static_cast<size_t>(pfx_pages[t / PS]) * PS + t % PS) * KD + h * DH;
          kr[i] = reinterpret_cast<const uint4*>(k_pages + at)[col];
          vr[i] = reinterpret_cast<const uint4*>(v_pages + at)[col];
        }
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = tid + i * THREADS, r = c / VEC, col = c % VEC;
        *reinterpret_cast<uint4*>(k_s + r * L::LDQ + col * 8) = kr[i];
        *reinterpret_cast<uint4*>(v_s + r * L::LDQ + col * 8) = vr[i];
      }
    }
    __syncthreads();

    // 2. scores of this warp's 16 rows against the tile: Q K^T
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[TT / 16];
#pragma unroll
      for (int j = 0; j < TT / 16; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, q_s + my_r * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int j = 0; j < TT / 16; ++j) {
          // K rows in shared memory are K^T in column-major order
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, k_s + j * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(sf[j], af, bf, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < TT / 16; ++j)
        wmma::store_matrix_sync(s_s + my_r * L::LDS + j * 16, sf[j], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // 3. online softmax, one row per lane pair; p under the mask
    {
      const float* srow = s_s + sm_r * L::LDS + half * 32;
      const int j0 = half * 32;
      float mx = NEG_INF;
#pragma unroll 8
      for (int u = 0; u < 32; ++u) {
        const int t = t0 + j0 + u;
        if (j0 + u < n && t < len && (window <= 0 || pos - t < window))
          mx = fmaxf(mx, srow[u] * scale);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[sm_r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll 8
      for (int u = 0; u < 32; ++u) {
        const int t = t0 + j0 + u;
        const bool ok = j0 + u < n && t < len && (window <= 0 || pos - t < window);
        const float pv = ok ? __expf(srow[u] * scale - m_new) : 0.f;
        const __nv_bfloat16 hi = __float2bfloat16(pv);
        p_s[sm_r * L::LDP + j0 + u] = hi;
        plo_s[sm_r * L::LDP + j0 + u] = __float2bfloat16(pv - __bfloat162float(hi));
        sum += pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = __expf(m_old - m_new);
      for (int d = half; d < DH; d += 2) a_s[sm_r * L::LDA + d] *= alpha;
      __syncwarp();  // both lanes have read m_s before it changes
      if (half == 0) { l_s[sm_r] = l_s[sm_r] * alpha + sum; m_s[sm_r] = m_new; }
    }
    __syncwarp();

    // 4. acc += (P_hi + P_lo) V for the 16 rows
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
      float* dst = a_s + my_r * L::LDA + j * 16;
      wmma::load_matrix_sync(cf, dst, L::LDA, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf, pl;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p_s + my_r * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(pl, plo_s + my_r * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(vf, v_s + kk * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(cf, pf, vf, cf);
        wmma::mma_sync(cf, pl, vf, cf);
      }
      wmma::store_matrix_sync(dst, cf, L::LDA, wmma::mem_row_major);
    }
    __syncthreads();  // the next tile overwrites k_s / v_s
  }

  // this split's carry for the block's rows
  const size_t base = static_cast<size_t>(split) * B * NH;
  for (int c = tid; c < QT * DH; c += THREADS) {
    const int r = c / DH, d = c % DH, row = r0 + r;
    if (row >= BG) continue;
    const size_t bn = base + static_cast<size_t>(row / G) * NH + h * G + row % G;
    acc_out[bn * DH + d] = a_s[r * L::LDA + d];
    if (d == 0) { m_out[bn] = m_s[r]; l_out[bn] = l_s[r]; }
  }
}

// partial carries [S, B*NH(, DH)] -> one carry [B*NH(, DH)]
template <int DH>
__global__ void __launch_bounds__(DH) prefix_carry_combine(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int S, int BN)
{
  const int bn = blockIdx.x, d = threadIdx.x;
  float m = NEG_INF;
  for (int s = 0; s < S; ++s) m = fmaxf(m, m_part[static_cast<size_t>(s) * BN + bn]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t i = static_cast<size_t>(s) * BN + bn;
    const float w = __expf(m_part[i] - m);  // 1 for an all-masked row: l, acc are 0
    l += w * l_part[i];
    a += w * acc_part[i * DH + d];
  }
  acc_out[static_cast<size_t>(bn) * DH + d] = a;
  if (d == 0) { m_out[bn] = m; l_out[bn] = l; }
}

template <int DH>
int launch(const void* q, const void* kp, const void* vp, const void* pages,
           const void* pfx_len, const void* q_pos, void* m0, void* l0, void* acc0,
           void* m_part, void* l_part, void* acc_part, int B, int NH, int KVH, int PS,
           int Pp, int window, int n_split, float scale, cudaStream_t stream)
{
  const size_t smem = Smem<DH>::bytes;
  auto kern = prefix_carry_kernel<DH>;
  static bool smem_set = false;  // once per instantiation (host side)
  cudaError_t e = cudaSuccess;
  if (!smem_set) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int G = NH / KVH;
  const int n_tiles = (Pp * PS + TT - 1) / TT;
  const int per = (n_tiles + n_split - 1) / n_split;
  const bool split = n_split > 1;
  kern<<<dim3(KVH, (B * G + QT - 1) / QT, n_split), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int32_t*>(pages),
      static_cast<const int32_t*>(pfx_len), static_cast<const int32_t*>(q_pos),
      static_cast<float*>(split ? m_part : m0), static_cast<float*>(split ? l_part : l0),
      static_cast<float*>(split ? acc_part : acc0), B, NH, KVH, PS, Pp, window, per, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return static_cast<int>(e);
  prefix_carry_combine<DH><<<B * NH, DH, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<float*>(m0), static_cast<float*>(l0),
      static_cast<float*>(acc0), n_split, B * NH);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_split > 1 needs m_part/l_part [n_split, B, NH] and acc_part
// [n_split, B, NH, Dh] f32 scratch; with n_split == 1 they may be null.
extern "C" int prefix_carry_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* pfx_pages,
    const void* pfx_len, const void* q_pos, void* m0, void* l0, void* acc0,
    void* m_part, void* l_part, void* acc_part, int B, int NH, int KVH, int Dh, int PS,
    int Pp, int window, int n_split, float scale, void* stream)
{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (n_split < 1 || Pp < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (Dh) {
    case 64:
      return launch<64>(q, k_pages, v_pages, pfx_pages, pfx_len, q_pos, m0, l0, acc0, m_part,
                        l_part, acc_part, B, NH, KVH, PS, Pp, window, n_split, scale, s);
    case 128:
      return launch<128>(q, k_pages, v_pages, pfx_pages, pfx_len, q_pos, m0, l0, acc0, m_part,
                         l_part, acc_part, B, NH, KVH, PS, Pp, window, n_split, scale, s);
    case 256:
      return launch<256>(q, k_pages, v_pages, pfx_pages, pfx_len, q_pos, m0, l0, acc0, m_part,
                         l_part, acc_part, B, NH, KVH, PS, Pp, window, n_split, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
