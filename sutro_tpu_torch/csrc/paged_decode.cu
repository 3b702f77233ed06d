// Paged-KV decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_paged.py::paged_decode_attention
// (kernel body _paged_decode_kernel). One query token per row attends
// over the row's pages (walk bounded by past_len), the fused-window
// slots that are not in the pool yet (slot < win_len, at past+slot),
// and the current token (at past+win_len). Per-layer sliding window;
// the attention sink joins the softmax denominator only. f32 online
// softmax; NEG_INF is -1e30 as in the reference.
//
// What bounds it on this card: bytes. Every live token's K and V row of
// the layer is read once per step (2 * past * KVH*Dh * 2 bytes per row),
// against ~2 flops per byte read; at 3.35 TB/s that is far below the
// tensor-core line, so the card waits on memory.
//
// What the design does about it: one block per (row, KV head) holds the
// G query heads of that group, so each K/V row is read from device
// memory once for all G heads (GQA reuse), with 16-byte loads of whole
// Dh-wide rows into shared memory. The page walk stops at the row's own
// past_len and starts at the first in-window token, so unused table
// slots and out-of-window pages cost nothing. Scores, the online-softmax
// update and the value sum run from shared memory in f32. Split-K
// flash-decoding (several blocks per row for long contexts) and a
// cp.async double buffer are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ACC = 16;  // G * Dh <= THREADS * MAX_ACC (wrapper checks)

// One tile of at most TT key/value rows, gathered from wherever the
// source functor points (a page row, a window slot, the current token).
template <int DH, int TT, typename Src>
__device__ __forceinline__ void attend_tile(
    const Src& src, int n, int G,
    __nv_bfloat16* ks, __nv_bfloat16* vs, const float* qs, float* ss,
    float* m_s, float* l_s, float* alpha_s, float (&acc)[MAX_ACC])
{
  constexpr int ROW = DH + 8;     // padded row: 16-byte aligned, spreads banks
  constexpr int VEC = DH / 8;     // uint4 chunks per row
  const int tid = threadIdx.x;

  // 1. gather K/V rows into shared memory (rows >= n are zero, so a
  //    masked column can never bring NaN into the value sum)
  for (int c = tid; c < TT * VEC; c += THREADS) {
    const int r = c / VEC, col = c % VEC;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < n) {
      kv = reinterpret_cast<const uint4*>(src.k(r))[col];
      vv = reinterpret_cast<const uint4*>(src.v(r))[col];
    }
    *reinterpret_cast<uint4*>(ks + r * ROW + col * 8) = kv;
    *reinterpret_cast<uint4*>(vs + r * ROW + col * 8) = vv;
  }
  __syncthreads();

  // 2. scores for every (head, row) pair; q is pre-scaled
  for (int idx = tid; idx < G * TT; idx += THREADS) {
    const int g = idx / TT, j = idx % TT;
    float s = NEG_INF;
    if (j < n && src.valid(j)) {
      const float* qg = qs + g * DH;
      const __nv_bfloat16* kr = ks + j * ROW;
      float dot = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(k2[e]);
          dot += qg[d + 2 * e] * kf.x + qg[d + 2 * e + 1] * kf.y;
        }
      }
      s = dot;
    }
    ss[g * TT + j] = s;
  }
  __syncthreads();

  // 3. online-softmax update, one warp per head; p is taken under the
  //    mask so an all-masked tile adds 0, not exp(-inf - -inf) = 1
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
    for (int j = lane; j < TT; j += 32) mx = fmaxf(mx, ss[g * TT + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = m_s[g];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = lane; j < TT; j += 32) {
      const float s = ss[g * TT + j];
      const float p = (s > 0.5f * NEG_INF) ? __expf(s - m_new) : 0.f;
      ss[g * TT + j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float alpha = __expf(m_old - m_new);
      alpha_s[g] = alpha;
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
    }
  }
  __syncthreads();

  // 4. value sum: each thread owns outputs o = tid + i*THREADS of [G, DH]
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int o = tid + i * THREADS;
    if (o < G * DH) {
      const int g = o / DH, d = o % DH;
      const float* pg = ss + g * TT;
      float a = acc[i] * alpha_s[g];
      for (int j = 0; j < n; ++j) a += pg[j] * __bfloat162float(vs[j * ROW + d]);
      acc[i] = a;
    }
  }
  __syncthreads();  // the next tile overwrites ks/vs/ss
}

struct PageSrc {
  const __nv_bfloat16* kp;
  const __nv_bfloat16* vp;
  const int32_t* table_row;
  int t0, PS, KD, off, pos, window, past;
  __device__ size_t at(int r) const {
    const int t = t0 + r;
    const int page = table_row[t / PS];
    return (static_cast<size_t>(page) * PS + t % PS) * KD + off;
  }
  __device__ const __nv_bfloat16* k(int r) const { return kp + at(r); }
  __device__ const __nv_bfloat16* v(int r) const { return vp + at(r); }
  __device__ bool valid(int r) const {
    const int t = t0 + r;
    return t < past && (window <= 0 || pos - t < window);
  }
};

// window slots u < W, then the current token at u == W
struct WindowSrc {
  const __nv_bfloat16* wk;  // row b's [W, KD] (may be null when W == 0)
  const __nv_bfloat16* wv;
  const __nv_bfloat16* kc;  // row b's current token [KD]
  const __nv_bfloat16* vc;
  int u0, W, KD, off, win_len, window;
  __device__ const __nv_bfloat16* k(int r) const {
    const int u = u0 + r;
    return (u < W ? wk + static_cast<size_t>(u) * KD : kc) + off;
  }
  __device__ const __nv_bfloat16* v(int r) const {
    const int u = u0 + r;
    return (u < W ? wv + static_cast<size_t>(u) * KD : vc) + off;
  }
  __device__ bool valid(int r) const {
    const int u = u0 + r;
    if (u == W) return true;
    return u < win_len && (window <= 0 || win_len - u < window);
  }
};

template <int DH, int TT>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, NH, DH]
    const __nv_bfloat16* __restrict__ k_pages,  // [NP, PS, KD]
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ table,          // [B, MP]
    const int32_t* __restrict__ past_len,       // [B]
    const __nv_bfloat16* __restrict__ k_cur,    // [B, KD]
    const __nv_bfloat16* __restrict__ v_cur,
    const __nv_bfloat16* __restrict__ win_k,    // [B, W, KD] or null
    const __nv_bfloat16* __restrict__ win_v,
    const float* __restrict__ sink,             // [NH] or null
    __nv_bfloat16* __restrict__ out,            // [B, NH, DH]
    int NH, int KVH, int PS, int MP, int W, int win_len, int window,
    float scale)
{
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ROW = DH + 8;
  const int G = NH / KVH;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + TT * ROW;
  float* qs = reinterpret_cast<float*>(vs + TT * ROW);
  float* ss = qs + G * DH;
  float* m_s = ss + G * TT;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int KD = KVH * DH, off = h * DH;
  const int past = past_len[b];
  const int pos = past + win_len;

  for (int i = tid; i < G * DH; i += THREADS)
    qs[i] = __bfloat162float(q[(static_cast<size_t>(b) * NH + h * G) * DH + i]) * scale;
  if (tid < G) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.f;
  __syncthreads();

  // page walk: from the first in-window token to past_len
  int t_lo = 0;
  if (window > 0 && pos - window + 1 > 0) t_lo = (pos - window + 1) / TT * TT;
  PageSrc ps{k_pages, v_pages, table + static_cast<size_t>(b) * MP,
             0, PS, KD, off, pos, window, past};
  for (int t0 = t_lo; t0 < past; t0 += TT) {
    ps.t0 = t0;
    attend_tile<DH, TT>(ps, min(TT, past - t0), G, ks, vs, qs, ss, m_s, l_s, alpha_s, acc);
  }
  // fused-window slots, then the current token
  WindowSrc ws{W ? win_k + static_cast<size_t>(b) * W * KD : nullptr,
               W ? win_v + static_cast<size_t>(b) * W * KD : nullptr,
               k_cur + static_cast<size_t>(b) * KD, v_cur + static_cast<size_t>(b) * KD,
               0, W, KD, off, win_len, window};
  for (int u0 = 0; u0 <= W; u0 += TT) {
    ws.u0 = u0;
    attend_tile<DH, TT>(ws, min(TT, W + 1 - u0), G, ks, vs, qs, ss, m_s, l_s, alpha_s, acc);
  }

  // sink: one more logit in the denominator, with no value row
  if (sink != nullptr && tid < G) {
    const float sk = sink[h * G + tid];
    const float m_new = fmaxf(m_s[tid], sk);
    const float alpha = __expf(m_s[tid] - m_new);
    alpha_s[tid] = alpha;
    l_s[tid] = l_s[tid] * alpha + __expf(sk - m_new);
  } else if (tid < G) {
    alpha_s[tid] = 1.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int o = tid + i * THREADS;
    if (o < G * DH) {
      const int g = o / DH;
      const float val = acc[i] * alpha_s[g] / fmaxf(l_s[g], 1e-30f);
      out[(static_cast<size_t>(b) * NH + h * G) * DH + o] = __float2bfloat16(val);
    }
  }
}

template <int DH, int TT>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* past_len, const void* k_cur, const void* v_cur,
           const void* win_k, const void* win_v, const void* sink, void* out,
           int B, int NH, int KVH, int PS, int MP, int W, int win_len,
           int window, float scale, cudaStream_t stream)
{
  const int G = NH / KVH;
  const size_t smem = 2 * TT * (DH + 8) * sizeof(__nv_bfloat16)
                    + (G * DH + G * TT + 3 * G) * sizeof(float);
  auto kern = paged_decode_kernel<DH, TT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(B, KVH), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(past_len), static_cast<const __nv_bfloat16*>(k_cur),
      static_cast<const __nv_bfloat16*>(v_cur), static_cast<const __nv_bfloat16*>(win_k),
      static_cast<const __nv_bfloat16*>(win_v), static_cast<const float*>(sink),
      static_cast<__nv_bfloat16*>(out), NH, KVH, PS, MP, W, win_len, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* past_len, const void* k_cur, const void* v_cur,
    const void* win_k, const void* win_v, const void* sink, void* out,
    int B, int NH, int KVH, int Dh, int PS, int MP, int W, int win_len,
    int window, float scale, void* stream)
{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return launch<64, 64>(q, k_pages, v_pages, table, past_len, k_cur, v_cur, win_k,
                            win_v, sink, out, B, NH, KVH, PS, MP, W, win_len, window, scale, s);
    case 128:
      return launch<128, 64>(q, k_pages, v_pages, table, past_len, k_cur, v_cur, win_k,
                             win_v, sink, out, B, NH, KVH, PS, MP, W, win_len, window, scale, s);
    case 256:
      return launch<256, 32>(q, k_pages, v_pages, table, past_len, k_cur, v_cur, win_k,
                             win_v, sink, out, B, NH, KVH, PS, MP, W, win_len, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
