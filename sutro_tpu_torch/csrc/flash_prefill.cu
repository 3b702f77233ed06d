// Causal flash prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_flash.py::flash_prefill (kernel body
// _flash_kernel). Self-attention over a chunk with no past: query and
// key positions are [0, T). GQA (query head n reads KV head n / G),
// causal mask, per-layer sliding window that skips whole key tiles, and
// the attention sink joining the denominator at finalize. f32 math;
// NEG_INF is -1e30 as in the reference.
//
// What bounds it on this card: operations. A row of T tokens costs
// 4 * T^2/2 * Dh flops per query head against 2 * T * Dh * 2 bytes of
// Q/K/V per head; from a few hundred tokens on that is above the
// ~295 flops/byte line where the tensor cores, not memory, limit.
//
// What the design does about it: one block per (row, query head,
// query tile) keeps the query tile, the current K/V tile and the score
// tile in shared memory, so the T x T score matrix never reaches device
// memory and each K/V tile is read once per query tile. Key tiles above
// the diagonal and wholly outside the window are never loaded. This
// first version multiplies with f32 FMAs on register tiles (4 x 8 score
// and 8 x Dh/16 output micro-tiles per thread); moving both products to
// the tensor cores (mma.sync / wgmma) is the next change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int BK = 64;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(p[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

template <int DH, int BQ>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, T, NH, DH]
    const __nv_bfloat16* __restrict__ k,   // [B, T, KVH, DH]
    const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ sink,        // [NH] or null
    __nv_bfloat16* __restrict__ out,       // [B, T, NH, DH]
    int T, int NH, int KVH, int window, float scale)
{
  constexpr int ROW = DH + 8;   // padded bf16 row, 16-byte aligned
  constexpr int SROW = BK + 1;  // padded f32 score row
  constexpr int VEC = DH / 8;
  constexpr int RPT = BQ / 8;   // query rows per thread (8 row groups)
  constexpr int CPT = DH / 16;  // output columns per thread (16 column groups)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * ROW;
  __nv_bfloat16* Vs = Ks + BK * ROW;
  float* S = reinterpret_cast<float*>(Vs + BK * ROW);
  float* m_s = S + BQ * SROW;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int G = NH / KVH, hk = hq / G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int c = tid; c < BQ * VEC; c += THREADS) {
    const int r = c / VEC, col = c % VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < T)
      val = reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * T + q0 + r) * NH + hq) * DH)[col];
    *reinterpret_cast<uint4*>(Qs + r * ROW + col * 8) = val;
  }
  if (tid < BQ) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[i][e] = 0.f;

  // key tiles: causal end at the tile's last query, window start at its
  // first query's oldest in-window key
  const int k_hi = min(q0 + BQ, T);
  int k_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) k_lo = (q0 - window + 1) / BK * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    for (int c = tid; c < BK * VEC; c += THREADS) {
      const int r = c / VEC, col = c % VEC;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) {
        const size_t base = ((static_cast<size_t>(b) * T + k0 + r) * KVH + hk) * DH;
        kv = reinterpret_cast<const uint4*>(k + base)[col];
        vv = reinterpret_cast<const uint4*>(v + base)[col];
      }
      *reinterpret_cast<uint4*>(Ks + r * ROW + col * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * ROW + col * 8) = vv;
    }
    __syncthreads();

    // scores: rows ty + 8i, columns tx + 16jj
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int d = 0; d < DH; d += 8) {
      float kf[4][8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        unpack8(*reinterpret_cast<const uint4*>(Ks + (tx + 16 * jj) * ROW + d), kf[jj]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float qf[8];
        unpack8(*reinterpret_cast<const uint4*>(Qs + (ty + 8 * i) * ROW + d), qf);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i][jj] += qf[e] * kf[jj][e];
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 8 * i, qp = q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj, kp = k0 + c;
        const bool ok = kp <= qp && kp < T && (window <= 0 || qp - kp < window);
        S[r * SROW + c] = ok ? s[i][jj] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per row; p under the mask
    for (int r = warp; r < BQ; r += THREADS / 32) {
      const float v0 = S[r * SROW + lane], v1 = S[r * SROW + lane + 32];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = v0 > 0.5f * NEG_INF ? __expf(v0 - m_new) : 0.f;
      const float p1 = v1 > 0.5f * NEG_INF ? __expf(v1 - m_new) : 0.f;
      S[r * SROW + lane] = p0;
      S[r * SROW + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // value sum: rows ty + 8i, columns tx*CPT .. tx*CPT + CPT-1
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[ty + 8 * i];
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[i][e] *= alpha;
    }
    const int kn = min(BK, T - k0);
    for (int j = 0; j < kn; ++j) {
      float vf[CPT];
      const __nv_bfloat162* vr =
          reinterpret_cast<const __nv_bfloat162*>(Vs + j * ROW + tx * CPT);
#pragma unroll
      for (int e = 0; e < CPT / 2; ++e) {
        const float2 x = __bfloat1622float2(vr[e]);
        vf[2 * e] = x.x;
        vf[2 * e + 1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = S[(ty + 8 * i) * SROW + j];
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[i][e] += p * vf[e];
      }
    }
    __syncthreads();  // next tile overwrites Ks/Vs/S
  }

  // finalize: the sink is one more logit in the denominator
  if (tid < BQ) {
    if (sink != nullptr) {
      const float sk = sink[hq];
      const float m_new = fmaxf(m_s[tid], sk);
      const float alpha = __expf(m_s[tid] - m_new);
      a_s[tid] = alpha;
      l_s[tid] = l_s[tid] * alpha + __expf(sk - m_new);
    } else {
      a_s[tid] = 1.f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r >= T) continue;
    const float f = a_s[r] / fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* o = out + ((static_cast<size_t>(b) * T + q0 + r) * NH + hq) * DH + tx * CPT;
#pragma unroll
    for (int e = 0; e < CPT; ++e) o[e] = __float2bfloat16(acc[i][e] * f);
  }
}

template <int DH, int BQ>
int launch(const void* q, const void* k, const void* v, const void* sink, void* out,
           int B, int T, int NH, int KVH, int window, float scale, cudaStream_t stream)
{
  const size_t smem = (BQ + 2 * BK) * (DH + 8) * sizeof(__nv_bfloat16)
                    + (BQ * (BK + 1) + 3 * BQ) * sizeof(float);
  auto kern = flash_prefill_kernel<DH, BQ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((T + BQ - 1) / BQ, NH, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(sink),
      static_cast<__nv_bfloat16*>(out), T, NH, KVH, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, const void* sink, void* out,
    int B, int T, int NH, int KVH, int Dh, int window, float scale, void* stream)
{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch<64, 64>(q, k, v, sink, out, B, T, NH, KVH, window, scale, s);
    case 128: return launch<128, 64>(q, k, v, sink, out, B, T, NH, KVH, window, scale, s);
    case 256: return launch<256, 32>(q, k, v, sink, out, B, T, NH, KVH, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
