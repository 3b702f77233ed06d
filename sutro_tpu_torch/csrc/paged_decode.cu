// Paged-KV decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_paged.py::paged_decode_attention
// (kernel body _paged_decode_kernel). One query token per row attends
// over the row's pages (walk bounded by past_len), the fused-window
// slots that are not in the pool yet (slot < win_len, at past+slot),
// and the current token (at past+win_len). Per-layer sliding window;
// the attention sink joins the softmax denominator only. f32 online
// softmax and accumulation; NEG_INF is -1e30 as in the reference.
//
// Carry option (the reference's shared-prefix mode, pfx_cnt/m0/l0/acc0):
// when pfx_cnt is not null, row b's page walk starts at page pfx_cnt[b]
// and the injected carry m0/l0 [B, NH], acc0 [B, NH, Dh]
// (prefix_carry.cu computes it once for a shared prefix) joins the
// merge as one more partial. A row outside any prefix group has
// pfx_cnt 0 and the cold carry (-1e30, 0, 0). The sink joins once, in
// the final denominator.
//
// int8-page option (the reference's k_scale/v_scale,
// pallas_paged.py:729-733, body :207-238, :295-326; entry point
// paged_decode_int8): pages are int8 with per-token f32 scales [NP, PS];
// q, the current token, the window slots and the output stay bf16. The
// dequantization folds in as the reference folds it: the K scale
// multiplies each page token's f32 score, q.(k*ks) = (q.k)*ks, and the
// V scale multiplies p before p is rounded for the value product,
// p.(v*vs) = (p*vs).v, while l sums the unscaled p. Page rows are staged
// as int8 (half the bytes of the bf16 pool) and widened to bf16 in
// registers as the fragments are built: |v| <= 127 is exact in bf16.
//
// What bounds it on this card: bytes. Every live token's K and V row of
// the layer is read once per step (2 * past * KVH*Dh * 2 bytes per row,
// half that over int8 pages) against ~2 flops per byte read; at
// 3.35 TB/s that is far below the tensor-core line.
//
// What the design does about it (split-K flash-decoding):
// 1. The key range is split. Block (split s, KV head h, row b) walks
//    the row's tokens [s * split, (s+1) * split) clipped to the first
//    in-window token (and, with the carry, the first page after the
//    shared prefix) and to past_len, so a long row gets many blocks
//    and the card fills whatever the rows' lengths. The split length
//    comes from the table's static width and the shapes (the wrapper's
//    plan), never from past_len, so nothing waits for the host. The
//    split that holds the row's last page token (split 0 for an empty
//    past) also takes the window slots and the current token. A block
//    with nothing to walk writes an empty partial (m = -1e30, l = 0;
//    its acc is never read) and exits.
// 2. Each block writes its partial (m, l, acc) per query head to
//    scratch; a second small kernel merges the partials of a row, the
//    carry as one more partial, and adds the sink once.
// 3. The G query heads of the KV group (padded to 16 rows) times a tile
//    of K is mma.sync.m16n8k16 bf16 with f32 accumulators, and so is
//    P V: q enters as the bf16 it is, Dh^-0.5 scales the f32 score, and
//    p enters P V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
//    so the value sum keeps ~16 bits of the reference's f32 p (one bf16
//    p moved a 48-layer model's logits measurably; the extra products
//    cost nothing on a kernel that waits on memory).
//    Each warp owns 16 tokens of a 64-token tile and keeps its own
//    online softmax in registers; the warps' states merge in shared
//    memory at the end of the block.
// 4. Tiles are double-buffered with cp.async (16 bytes a thread; each
//    row gathered through the page table), so the next tile streams in
//    while the current one is multiplied.
// Dh=256 takes 32-token tiles (2 warps) and reloads the q fragments
// from shared memory, to stay inside the register budget. G <= 16 (one
// m16 tile; the wrapper checks it).
//
// What still holds it back: the page rows are gathered one 16-byte
// copy at a time through the page table (no TMA), a G=4 or 8 group
// fills a quarter or half of the m16 tile, and the merge is a second
// launch that reads every live split's partial once more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
struct Tile {
  static constexpr int TT = DH <= 128 ? 64 : 32;  // tokens per tile
  static constexpr int WARPS = TT / 16;           // 16 tokens per warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWB = 2 * DH + 16;        // staged row bytes (bf16 width, padded)
  static constexpr int KV = TT * ROWB;            // one K or V tile
  static constexpr int STAGE = 2 * KV + 2 * TT * 4;  // K, V, K scales, V scales
  static constexpr int QB = 16 * ROWB;            // q rows (G of 16 used)
  static constexpr size_t smem = QB + 2 * size_t(STAGE);
  static constexpr bool Q_REGS = DH <= 128;
  static_assert(WARPS * 16 * (DH + 2) * 4 <= 2 * STAGE, "warp merge must fit the stages");
};

template <int DH>
__device__ __forceinline__ void load_b_k(uint32_t& b0, uint32_t& b1, const unsigned char* Ks,
                                         int row, int dh) {
  // B fragment of Q K^T for 8 tokens from row, dh .. dh+15 (int8 rows)
  const unsigned char* p = Ks + row * Tile<DH>::ROWB + dh;
  const char2 lo = *reinterpret_cast<const char2*>(p);
  const char2 hi = *reinterpret_cast<const char2*>(p + 8);
  b0 = pack_i8(lo.x, lo.y);
  b1 = pack_i8(hi.x, hi.y);
}

// One tile: this warp's 16 tokens against the 16 (padded) query rows.
// E is the staged rows' element type, SCALED adds the per-token scales
// (int8 pages); valid(r) says whether token r of the tile is a key.
template <int DH, typename E, bool SCALED, typename Valid>
__device__ __forceinline__ void attend(
    const unsigned char* Ks, const unsigned char* Vs, const float* ksc, const float* vsc,
    int n_tok, const Valid& valid, const uint32_t (&qf)[Tile<DH>::Q_REGS ? DH / 16 : 1][4],
    const unsigned char* Qs, float scale_log2, float (&m_r)[2], float (&l_r)[2],
    float (&o)[DH / 8][4])
{
  constexpr int ROWB = Tile<DH>::ROWB;
  constexpr bool INT8 = std::is_same<E, int8_t>::value;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  if (r0 >= n_tok) return;  // warp-uniform: nothing of this warp's in the tile

  // S = Q K^T: 16 query rows x 16 tokens
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    if constexpr (Tile<DH>::Q_REGS) {
      a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
    } else {
      ldsm_x4(a, Qs + (lane & 15) * ROWB + (kk * 16 + (lane >> 4) * 8) * 2);
    }
    if constexpr (INT8) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b0, b1;
        load_b_k<DH>(b0, b1, Ks, r0 + 8 * j + gid, kk * 16 + 2 * tig);
        mma_bf16(s[j], a, b0, b1);
      }
    } else {
      uint32_t bk[4];
      ldsm_x4(bk, Ks + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ROWB
                      + (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }
  }

  // f32 scale (and K scale), mask, online softmax over the quad
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * j + 2 * tig + (e & 1);
      float x = s[j][e] * scale_log2;
      if constexpr (SCALED) x *= ksc[r];
      x = (r < n_tok && valid(r)) ? x : NEG_INF;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = fast_exp2(m_r[i] - mx[i]);
    m_r[i] = mx[i];
    l_r[i] *= alpha[i];
  }
  // P as the A operand, bf16 hi + lo: (row gid, n-block 0), (gid+8, 0),
  // (gid, 1), (gid+8, 1)
  uint32_t ah[4], al[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e];
      p[e] = x > 0.5f * NEG_INF ? fast_exp2(x - mx[e >> 1]) : 0.f;  // p under the mask
    }
    l_r[0] += p[0] + p[1];
    l_r[1] += p[2] + p[3];
    float v0 = 1.f, v1 = 1.f;
    if constexpr (SCALED) {  // the V scale joins the value product only
      v0 = vsc[r0 + 8 * j + 2 * tig];
      v1 = vsc[r0 + 8 * j + 2 * tig + 1];
    }
    split_bf16(p[0] * v0, p[1] * v1, ah[2 * j], al[2 * j]);
    split_bf16(p[2] * v0, p[3] * v1, ah[2 * j + 1], al[2 * j + 1]);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
    o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
  }

  // O += P V over the warp's 16 tokens, four 8-column blocks at a time,
  // hi terms first, so no accumulator waits on the product just issued
#pragma unroll
  for (int n = 0; n < DH / 8; n += 4) {
    uint32_t b[4][2];
    if constexpr (INT8) {
      const int8_t* c = reinterpret_cast<const int8_t*>(Vs + (r0 + 2 * tig) * ROWB + n * 8 + gid);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i][0] = pack_i8(c[i * 8], c[i * 8 + ROWB]);
        b[i][1] = pack_i8(c[i * 8 + 8 * ROWB], c[i * 8 + 9 * ROWB]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROWB
                          + ((n + 2 * h) * 8 + (lane >> 4) * 8) * 2);
        b[2 * h][0] = bv[0]; b[2 * h][1] = bv[1];
        b[2 * h + 1][0] = bv[2]; b[2 * h + 1][1] = bv[3];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_bf16(o[n + i], ah, b[i][0], b[i][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_bf16(o[n + i], al, b[i][0], b[i][1]);
  }
}

template <int DH, typename PageT>
__global__ void __launch_bounds__(Tile<DH>::THREADS) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, NH, DH]
    const PageT* __restrict__ k_pages,          // [NP, PS, KD]
    const PageT* __restrict__ v_pages,
    const float* __restrict__ k_scale,          // [NP, PS] (int8 pages) or null
    const float* __restrict__ v_scale,
    const int32_t* __restrict__ table,          // [B, MP]
    const int32_t* __restrict__ past_len,       // [B]
    const __nv_bfloat16* __restrict__ k_cur,    // [B, KD]
    const __nv_bfloat16* __restrict__ v_cur,
    const __nv_bfloat16* __restrict__ win_k,    // [B, W, KD] or null
    const __nv_bfloat16* __restrict__ win_v,
    const int32_t* __restrict__ pfx_cnt,        // [B] or null (no carry)
    float* __restrict__ m_part,                 // [S, B, NH]
    float* __restrict__ l_part,
    float* __restrict__ acc_part,               // [S, B, NH, DH]
    int B, int NH, int KVH, int PS, int MP, int W, int win_len, int window,
    int split, float scale_log2)
{
  using C = Tile<DH>;
  constexpr int TT = C::TT, ROWB = C::ROWB, THREADS = C::THREADS, WARPS = C::WARPS;
  constexpr int ONB = DH / 8;
  constexpr bool SCALED = std::is_same<PageT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* stage0 = smem + C::QB;

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = NH / KVH, KD = KVH * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int past = past_len[b];
  const int pos = past + win_len;

  // this split's page tokens: from the first in-window token (and the
  // first page after the shared prefix) to past_len
  int t_lo = 0;
  if (window > 0 && pos - window + 1 > 0) t_lo = pos - window + 1;
  if (pfx_cnt != nullptr) t_lo = max(t_lo, pfx_cnt[b] * PS);
  const int lo = max(s * split, t_lo), hi = min((s + 1) * split, past);
  const bool tail = s == (past > 0 ? (past - 1) / split : 0);
  const size_t part = (size_t(s) * B + b) * NH + size_t(h) * G;  // [s, b, h*G]
  if (lo >= hi && !tail) {  // the empty partial
    if (tid < G) { m_part[part + tid] = NEG_INF; l_part[part + tid] = 0.f; }
    return;
  }
  const int n_tiles = lo < hi ? (hi - lo + TT - 1) / TT : 0;
  const int32_t* trow = table + size_t(b) * MP;
  const size_t off = size_t(h) * DH;

  auto load_pages = [&](int tile, int st) {
    unsigned char* Ks = stage0 + st * C::STAGE;
    unsigned char* Vs = Ks + C::KV;
    constexpr int VEC = DH * sizeof(PageT) / 16;
    const int t0 = lo + tile * TT;
    for (int c = tid; c < TT * VEC; c += THREADS) {
      const int r = c / VEC, col = c % VEC, t = t0 + r;
      const bool ok = t < hi;
      const size_t row = ok ? size_t(trow[t / PS]) * PS + t % PS : 0;
      cp_async16(Ks + r * ROWB + col * 16, k_pages + row * KD + off + col * (16 / sizeof(PageT)), ok);
      cp_async16(Vs + r * ROWB + col * 16, v_pages + row * KD + off + col * (16 / sizeof(PageT)), ok);
    }
    if constexpr (SCALED) {
      float* ks = reinterpret_cast<float*>(Vs + C::KV);
      for (int r = tid; r < TT; r += THREADS) {
        const int t = t0 + r;
        const bool ok = t < hi;
        const size_t row = ok ? size_t(trow[t / PS]) * PS + t % PS : 0;
        cp_async4(ks + r, k_scale + row, ok);
        cp_async4(ks + TT + r, v_scale + row, ok);
      }
    }
  };
  if (n_tiles > 0) load_pages(0, 0);
  cp_async_commit();

  // q rows of the group (rows >= G zero), while tile 0 is in flight
  {
    constexpr int VEC = DH / 8;
    const __nv_bfloat16* qb = q + (size_t(b) * NH + size_t(h) * G) * DH;
    for (int c = tid; c < 16 * VEC; c += THREADS) {
      const int r = c / VEC, col = c % VEC;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < G) val = reinterpret_cast<const uint4*>(qb + size_t(r) * DH)[col];
      *reinterpret_cast<uint4*>(Qs + r * ROWB + col * 16) = val;
    }
  }
  __syncthreads();
  uint32_t qf[C::Q_REGS ? DH / 16 : 1][4];
  if constexpr (C::Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ldsm_x4(qf[kk], Qs + (lane & 15) * ROWB + (kk * 16 + (lane >> 4) * 8) * 2);
  }

  float o[ONB][4];
#pragma unroll
  for (int n = 0; n < ONB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  // page tiles, double-buffered: every page token in [lo, hi) is a key
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) load_pages(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* Ks = stage0 + st * C::STAGE;
    const int n_tok = min(TT, hi - lo - it * TT);
    const float* ks = reinterpret_cast<const float*>(Ks + 2 * C::KV);
    attend<DH, PageT, SCALED>(Ks, Ks + C::KV, ks, ks + TT, n_tok, [](int) { return true; },
                              qf, Qs, scale_log2, m_r, l_r, o);
    __syncthreads();  // the next copy overwrites this stage
  }

  // the tail split: fused-window slots u < W, then the current token at u == W
  if (tail) {
    const __nv_bfloat16* wk = win_k + size_t(b) * W * KD;
    const __nv_bfloat16* wv = win_v + size_t(b) * W * KD;
    for (int u0 = 0; u0 <= W; u0 += TT) {
      unsigned char* Ks = stage0;
      unsigned char* Vs = Ks + C::KV;
      const int n_tok = min(TT, W + 1 - u0);
      constexpr int VEC = DH / 8;
      for (int c = tid; c < TT * VEC; c += THREADS) {
        const int r = c / VEC, col = c % VEC, u = u0 + r;
        const bool ok = r < n_tok;
        const __nv_bfloat16* ksrc = u < W ? wk + size_t(u) * KD : k_cur + size_t(b) * KD;
        const __nv_bfloat16* vsrc = u < W ? wv + size_t(u) * KD : v_cur + size_t(b) * KD;
        cp_async16(Ks + r * ROWB + col * 16, ok ? ksrc + off + col * 8 : k_cur, ok);
        cp_async16(Vs + r * ROWB + col * 16, ok ? vsrc + off + col * 8 : v_cur, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      auto valid = [=](int r) {
        const int u = u0 + r;
        return u == W || (u < win_len && (window <= 0 || win_len - u < window));
      };
      attend<DH, __nv_bfloat16, false>(Ks, Vs, nullptr, nullptr, n_tok, valid, qf, Qs,
                                       scale_log2, m_r, l_r, o);
      __syncthreads();
    }
  }

  // merge the warps' states in shared memory (the stages are free now)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  float* mw = reinterpret_cast<float*>(stage0);  // [WARPS][16]
  float* lw = mw + WARPS * 16;
  float* ow = lw + WARPS * 16;                   // [WARPS][16][DH]
  if (tig == 0) {
    mw[warp * 16 + gid] = m_r[0]; mw[warp * 16 + gid + 8] = m_r[1];
    lw[warp * 16 + gid] = l_r[0]; lw[warp * 16 + gid + 8] = l_r[1];
  }
#pragma unroll
  for (int n = 0; n < ONB; ++n) {
    float* r_lo = ow + (warp * 16 + gid) * DH + n * 8 + 2 * tig;
    float* r_hi = r_lo + 8 * DH;
    r_lo[0] = o[n][0]; r_lo[1] = o[n][1];
    r_hi[0] = o[n][2]; r_hi[1] = o[n][3];
  }
  __syncthreads();
  for (int idx = tid; idx < G * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * 16 + r]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = fast_exp2(mw[w * 16 + r] - M);
      A += ow[(w * 16 + r) * DH + d] * f;
      L += lw[w * 16 + r] * f;
    }
    acc_part[(part + r) * DH + d] = A;
    if (d == 0) { m_part[part + r] = M * LN2; l_part[part + r] = L; }
  }
}

// out[b, n] = (carry + every split's partial) / (l's + the sink), one
// block per (query head, row), one thread per column
template <int DH>
__global__ void __launch_bounds__(DH) paged_decode_merge_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, const float* __restrict__ sink,
    const int32_t* __restrict__ pfx_cnt, const float* __restrict__ m0,
    const float* __restrict__ l0, const float* __restrict__ acc0,
    __nv_bfloat16* __restrict__ out, int B, int NH, int S)
{
  const int n = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t bn = size_t(b) * NH + n;
  const size_t stride = size_t(B) * NH;
  const bool carry = pfx_cnt != nullptr;
  float M = carry ? m0[bn] : NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m_part[s * stride + bn]);
  if (sink != nullptr) M = fmaxf(M, sink[n]);
  float L = 0.f, A = 0.f;
  if (carry) {
    const float f = __expf(m0[bn] - M);
    L = l0[bn] * f;
    A = acc0[bn * DH + d] * f;
  }
  for (int s = 0; s < S; ++s) {
    const float l = l_part[s * stride + bn];
    if (l > 0.f) {  // an empty partial's acc is never written
      const float f = __expf(m_part[s * stride + bn] - M);
      L += l * f;
      A += acc_part[(s * stride + bn) * DH + d] * f;
    }
  }
  if (sink != nullptr) L += __expf(sink[n] - M);
  out[bn * DH + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
}

template <int DH, typename PageT>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* table, const void* past_len, const void* k_cur,
           const void* v_cur, const void* win_k, const void* win_v, const void* sink,
           const void* pfx_cnt, const void* m0, const void* l0, const void* acc0,
           void* out, void* work, int B, int NH, int KVH, int PS, int MP, int W,
           int win_len, int window, int split, int S, float scale, cudaStream_t stream)
{
  using C = Tile<DH>;
  auto kern = paged_decode_split_kernel<DH, PageT>;
  if (C::smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t n_part = size_t(S) * B * NH;
  float* m_part = static_cast<float*>(work);
  float* l_part = m_part + n_part;
  float* acc_part = l_part + n_part;
  kern<<<dim3(S, KVH, B), C::THREADS, C::smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const PageT*>(kp),
      static_cast<const PageT*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(past_len), static_cast<const __nv_bfloat16*>(k_cur),
      static_cast<const __nv_bfloat16*>(v_cur), static_cast<const __nv_bfloat16*>(win_k),
      static_cast<const __nv_bfloat16*>(win_v), static_cast<const int32_t*>(pfx_cnt),
      m_part, l_part, acc_part, B, NH, KVH, PS, MP, W, win_len, window, split,
      scale * LOG2E);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_decode_merge_kernel<DH><<<dim3(NH, B), DH, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<const float*>(sink),
      static_cast<const int32_t*>(pfx_cnt), static_cast<const float*>(m0),
      static_cast<const float*>(l0), static_cast<const float*>(acc0),
      static_cast<__nv_bfloat16*>(out), B, NH, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename PageT>
int dispatch(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
             const void* v_scale, const void* table, const void* past_len,
             const void* k_cur, const void* v_cur, const void* win_k, const void* win_v,
             const void* sink, const void* pfx_cnt, const void* m0, const void* l0,
             const void* acc0, void* out, void* work, int B, int NH, int KVH, int Dh,
             int PS, int MP, int W, int win_len, int window, int split, int S, float scale,
             void* stream)
{
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (NH % KVH || NH / KVH > 16 || split <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_DECODE_LAUNCH(DH_)                                                           \
  launch<DH_, PageT>(q, k_pages, v_pages, k_scale, v_scale, table, past_len, k_cur, v_cur, \
                     win_k, win_v, sink, pfx_cnt, m0, l0, acc0, out, work, B, NH, KVH, PS, \
                     MP, W, win_len, window, split, S, scale, st)
  switch (Dh) {
    case 64: return PAGED_DECODE_LAUNCH(64);
    case 128: return PAGED_DECODE_LAUNCH(128);
    case 256: return PAGED_DECODE_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_DECODE_LAUNCH
}

}  // namespace

// work: float32 scratch of S * B * NH * (Dh + 2) (the partials); split:
// tokens per split; S: splits (ceil(MP * PS / split))
extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* past_len, const void* k_cur, const void* v_cur,
    const void* win_k, const void* win_v, const void* sink, const void* pfx_cnt,
    const void* m0, const void* l0, const void* acc0, void* out, void* work,
    int B, int NH, int KVH, int Dh, int PS, int MP, int W, int win_len,
    int window, int split, int S, float scale, void* stream)
{
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, table, past_len,
                                 k_cur, v_cur, win_k, win_v, sink, pfx_cnt, m0, l0, acc0,
                                 out, work, B, NH, KVH, Dh, PS, MP, W, win_len, window,
                                 split, S, scale, stream);
}

// int8 pages with per-token scales k_scale/v_scale [NP, PS] f32
extern "C" int paged_decode_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* past_len, const void* k_cur, const void* v_cur,
    const void* win_k, const void* win_v, const void* sink, const void* pfx_cnt,
    const void* m0, const void* l0, const void* acc0, const void* k_scale,
    const void* v_scale, void* out, void* work,
    int B, int NH, int KVH, int Dh, int PS, int MP, int W, int win_len,
    int window, int split, int S, float scale, void* stream)
{
  return dispatch<int8_t>(q, k_pages, v_pages, k_scale, v_scale, table, past_len, k_cur,
                          v_cur, win_k, win_v, sink, pfx_cnt, m0, l0, acc0, out, work, B,
                          NH, KVH, Dh, PS, MP, W, win_len, window, split, S, scale, stream);
}
