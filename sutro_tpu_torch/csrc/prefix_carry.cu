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
// What bounds it on this card: at the serve's shapes, neither bytes nor
// operations but latency. For one KV head the B*G queries against the
// prefix are two matrix products, S = Q K^T and P V (4 * B*G * Lp * Dh
// flops: ~1 GFLOP for qwen3-30b-a3b's 64 rows x 32 heads over a
// 1,024-token template, ~1 us at the H100 SXM's published bf16 peak),
// against one read of the prefix's K/V rows (2 MB, ~0.6 us at its
// published 3.35 TB/s). So few blocks exist (4 KV heads x
// 8 query tiles) that each SM holds one, and what counts is how long one
// block's walk over its tiles takes.
//
// What the design does about it (FlashAttention-2 over a shared key
// set): the B*G query rows of one KV head are the M side. One block of
// 8 warps per (KV head, 64 query rows, split of the prefix): each 16
// rows belong to two warps, one for each 64-token tile of a 128-token
// stage, so twice the warps hide each other's latency without more
// splits; at the end the two carries of the same rows merge in shared
// memory. Both products run as mma.sync.m16n8k16 bf16 with f32
// accumulators, fragments loaded with ldmatrix (.trans for V) from rows
// padded by 16 bytes. Q goes to registers once per block (at Dh=256 it
// stays in shared memory: 16 rows x 256 of acc already take 128
// registers a thread); the scores, the masks (length and window), the
// online softmax (row max over the quad by shuffles) and the
// accumulator never leave registers. p enters P V as bf16 hi + lo, which
// keeps ~16 bits of the reference's f32 p: one bf16 p moved a 48-layer
// MoE model's prefill logits to the edge of their 5e-2 check (flash
// prefill, PERF.md). K/V tiles of 64 tokens (32 at Dh=256) are gathered
// through pfx_pages into a two-stage cp.async ring, so the next stage
// streams in while one is multiplied. Tiles outside every row's [window
// start, pfx_len) are never read; a warp whose 16 rows have no key in a
// tile (rows outside the group) skips its products there but takes part
// in the copies and barriers. The wrapper (ops/prefix_carry.py
// split_plan) cuts the prefix into few, long splits: a grid of at most
// one wave at one block an SM, at least 4 tiles a block; a second
// kernel combines the partials, reading each once in 16-byte vectors.
//
// What still holds it back: a block's walk over its tiles is a chain of
// mma.sync, ldmatrix and shuffles; the ring's depth (2, 3, 4 or 6
// stages) measured alike, so the copies are hidden and the products'
// latency is not. The hi + lo split doubles P V's products, and the
// combine is a second launch.

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
constexpr int ROW_WARPS = 4;           // warps along the query rows, 16 rows each
constexpr int QT = 16 * ROW_WARPS;     // query rows (b, g) per block
constexpr int KG = 2;                  // key groups: warps w and w + 4 share 16 rows
constexpr int WARPS = ROW_WARPS * KG;  // and take the two tiles of a stage one each
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;              // stages in the ring (2, 3, 4 and 6 measured alike)

// prefix tokens per tile (ops/prefix_carry.py TILE_TOKENS)
template <int DH>
__host__ __device__ constexpr int tile_tokens() { return DH == 256 ? 32 : 64; }
// Q in registers, staged in the last stage's K rows until the first
// tiles have landed
template <int DH>
__host__ __device__ constexpr bool q_in_registers() { return DH <= 128; }

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {  // [Q tile,] STAGES stages of (K, V)
  return size_t((q_in_registers<DH>() ? 0 : QT) + 2 * STAGES * KG * tile_tokens<DH>())
         * (DH + 8) * sizeof(__nv_bfloat16);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1) prefix_carry_kernel(
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
    float scale_log2)
{
  constexpr int TT = tile_tokens<DH>();
  constexpr int ROW = DH + 8;      // padded bf16 row
  constexpr int VEC = DH / 8;      // 16-byte chunks per row
  constexpr int KSTEPS = DH / 16;  // k-steps of Q K^T
  constexpr int NB = TT / 8;       // 8-key score blocks
  constexpr int ONB = DH / 8;      // 8-column accumulator blocks
  constexpr int ST_ROWS = KG * TT;  // token rows of a stage
  constexpr bool Q_REGS = q_in_registers<DH>();
  static_assert(!Q_REGS || ST_ROWS >= QT, "Q is staged in a stage's K rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem_raw) + (Q_REGS ? 0 : QT * ROW);
  __nv_bfloat16* Qs =
      Q_REGS ? KVs + 2 * (STAGES - 1) * ST_ROWS * ROW : reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ int range_s[2 * WARPS];  // per warp: first key, end of keys

  const int h = blockIdx.x, r0 = blockIdx.y * QT, split = blockIdx.z;
  const int G = NH / KVH, BG = B * G, KD = KVH * DH, Lp = Pp * PS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int rw = warp % ROW_WARPS, kg = warp / ROW_WARPS;  // row group, key group

  // rows gid and gid+8 of this warp see keys [lo, hi): the window's
  // first key to the end of the row's prefix (empty outside the group)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rw * 16 + gid + 8 * r;
    lo[r] = 0;
    hi[r] = 0;
    if (row < BG) {
      const int b = row / G;
      hi[r] = min(pfx_len[b], Lp);
      if (window > 0) lo[r] = max(0, q_pos[b] - window + 1);
    }
  }
  // the warp's key range: the union over its live rows
  int w_lo = Lp, w_hi = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (lo[r] < hi[r]) w_lo = min(w_lo, lo[r]), w_hi = max(w_hi, hi[r]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, o));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, o));
  }
  if (lane == 0) range_s[2 * warp] = w_lo, range_s[2 * warp + 1] = w_hi;
  __syncthreads();
  int b_lo = Lp, b_hi = 0;  // the block's: the union over its warps
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    b_lo = min(b_lo, range_s[2 * w]), b_hi = max(b_hi, range_s[2 * w + 1]);

  // this split's tiles, clipped to the block's key range
  const int s_begin = split * tiles_per_split * TT;
  const int first = max(s_begin, b_lo / TT * TT);
  const int end = min(min(s_begin + tiles_per_split * TT, Lp), b_hi);
  const int n_iter = end > first ? (end - first + ST_ROWS - 1) / ST_ROWS : 0;
  // a stage may reach past the split's end (its rows there are zero):
  // those keys are the next split's
#pragma unroll
  for (int r = 0; r < 2; ++r) hi[r] = min(hi[r], end);

  const size_t base = static_cast<size_t>(split) * B * NH;
  float o[ONB][4];
#pragma unroll
  for (int n = 0; n < ONB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};  // m in log2 units

  if (n_iter > 0) {
    // the query tile (rows past B*G are zero) rides with stage 0
    for (int c = tid; c < QT * VEC; c += THREADS) {
      const int r = c / VEC, col = c % VEC, row = r0 + r;
      const bool ok = row < BG;
      const int b = ok ? row / G : 0, n = ok ? h * G + row % G : 0;
      cp_async16(Qs + r * ROW + col * 8, q + (static_cast<size_t>(b) * NH + n) * DH + col * 8,
                 ok);
    }
    // a stage's K/V rows of head h (KG tiles), gathered through the
    // prefix's pages (rows at or past `end` are zero, so 0 * p adds no NaN)
    auto load_kv = [&](int iter, int st) {
      const int t0 = first + iter * ST_ROWS;
      __nv_bfloat16* Ks = KVs + (2 * st) * ST_ROWS * ROW;
      __nv_bfloat16* Vs = Ks + ST_ROWS * ROW;
      for (int c = tid; c < ST_ROWS * VEC; c += THREADS) {
        const int r = c / VEC, col = c % VEC, t = t0 + r;
        const bool ok = t < end;
        const size_t at =
            ok ? (static_cast<size_t>(pfx_pages[t / PS]) * PS + t % PS) * KD + h * DH + col * 8
               : 0;
        cp_async16(Ks + r * ROW + col * 8, k_pages + at, ok);
        cp_async16(Vs + r * ROW + col * 8, v_pages + at, ok);
      }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_iter) load_kv(i, i);
      cp_async_commit();
    }

    const __nv_bfloat16* Qw = Qs + rw * 16 * ROW;  // this warp's 16 query rows
    uint32_t qf[Q_REGS ? KSTEPS : 1][4];

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      cp_async_wait<STAGES - 2>();  // this stage (and Q) has landed
      __syncthreads();              // ... for every thread; the stage freed by
                                    // the last iteration is read by no one
      if constexpr (Q_REGS) {
        if (it == 0) {
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk)
            ldsm_x4(qf[kk], Qw + (lane & 15) * ROW + kk * 16 + (lane >> 4) * 8);
          __syncthreads();  // Q's rows are the next copy's target
        }
      }
      const int nxt = it + STAGES - 1;
      if (nxt < n_iter) load_kv(nxt, nxt % STAGES);
      cp_async_commit();
      // this warp's tile of the stage
      const int t0 = first + it * ST_ROWS + kg * TT;
      // no key of this warp's rows in its tile: skip the products
      if (t0 >= min(w_hi, end) || t0 + TT <= w_lo) continue;
      const __nv_bfloat16* Ks = KVs + (2 * st) * ST_ROWS * ROW + kg * TT * ROW;
      const __nv_bfloat16* Vs = Ks + ST_ROWS * ROW;

      // S = Q K^T: 16 rows x TT keys
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        if constexpr (Q_REGS) {
          a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
        } else {
          ldsm_x4(a, Qw + (lane & 15) * ROW + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int j = 0; j < NB; j += 2) {  // two 8-key blocks per ldmatrix.x4
          uint32_t bk[4];
          ldsm_x4(bk, Ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * ROW + kk * 16
                          + ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], a, bk[0], bk[1]);
          mma_bf16(s[j + 1], a, bk[2], bk[3]);
        }
      }

      // scale in f32 (log2 units), mask by each row's [lo, hi), online
      // softmax with p under the mask
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + j * 8 + 2 * tig + (e & 1), r = e >> 1;
          const float x = (t >= lo[r] && t < hi[r]) ? s[j][e] * scale_log2 : NEG_INF;
          s[j][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2(m_r[r] - mx[r]);
        m_r[r] = mx[r];
        l_r[r] *= alpha[r];
      }
      uint32_t ph[NB][2], pl[NB][2];  // p as bf16 hi + lo pairs: rows gid, gid+8
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          p[e] = x > 0.5f * NEG_INF ? fast_exp2(x - mx[e >> 1]) : 0.f;
        }
        l_r[0] += p[0] + p[1];
        l_r[1] += p[2] + p[3];
        split_bf16(p[0], p[1], ph[j][0], pl[j][0]);
        split_bf16(p[2], p[3], ph[j][1], pl[j][1]);
      }
#pragma unroll
      for (int n = 0; n < ONB; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }

      // acc += (P_hi + P_lo) V: the score fragment is the A operand as it
      // stands; p's hi and lo terms share each V fragment
#pragma unroll
      for (int kk = 0; kk < TT / 16; ++kk) {
        const uint32_t ah[4] = {ph[2 * kk][0], ph[2 * kk][1], ph[2 * kk + 1][0],
                                ph[2 * kk + 1][1]};
        const uint32_t al[4] = {pl[2 * kk][0], pl[2 * kk][1], pl[2 * kk + 1][0],
                                pl[2 * kk + 1][1]};
#pragma unroll
        for (int n = 0; n < ONB; n += 2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW + n * 8
                            + (lane >> 4) * 8);
          mma_bf16(o[n], ah, bv[0], bv[1]);
          mma_bf16(o[n + 1], ah, bv[2], bv[3]);
          mma_bf16(o[n], al, bv[0], bv[1]);
          mma_bf16(o[n + 1], al, bv[2], bv[3]);
        }
      }
    }
    cp_async_wait<0>();  // no copy outlives the block
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // l over the quad
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }

  // the key groups' carries of the same rows merge in shared memory (the
  // ring's, now free): group 1 leaves its m, l and acc in fragment order,
  // group 0 rescales both to the common max and adds
  static_assert(KG == 2, "two key groups merge");
  static_assert((ONB * 4 + 4) * ROW_WARPS * 32 * 4 <= smem_bytes<DH>(),
                "the merge fits in the ring");
  __syncthreads();
  float* x_acc = reinterpret_cast<float*>(smem_raw);  // [ONB * 4][ROW_WARPS * 32]
  float* x_ml = x_acc + ONB * 4 * ROW_WARPS * 32;     // [4][ROW_WARPS * 32]
  const int xp = rw * 32 + lane;
  if (kg == 1) {
#pragma unroll
    for (int n = 0; n < ONB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x_acc[(n * 4 + e) * ROW_WARPS * 32 + xp] = o[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x_ml[r * ROW_WARPS * 32 + xp] = m_r[r];
      x_ml[(2 + r) * ROW_WARPS * 32 + xp] = l_r[r];
    }
  }
  __syncthreads();
  if (kg == 1) return;
  float a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = x_ml[r * ROW_WARPS * 32 + xp], mn = fmaxf(m_r[r], m1);
    const float a0 = fast_exp2(m_r[r] - mn);  // both 1 for a row with no key
    a1[r] = fast_exp2(m1 - mn);
    l_r[r] = l_r[r] * a0 + x_ml[(2 + r) * ROW_WARPS * 32 + xp] * a1[r];
    m_r[r] = mn;
#pragma unroll
    for (int n = 0; n < ONB; ++n) o[n][2 * r] *= a0, o[n][2 * r + 1] *= a0;
  }
#pragma unroll
  for (int n = 0; n < ONB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += x_acc[(n * 4 + e) * ROW_WARPS * 32 + xp] * a1[e >> 1];

  // this split's carry for the warp's rows: m in natural units (-1e30
  // where no key was seen), l, acc from registers
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rw * 16 + gid + 8 * r;
    const float l = l_r[r];
    if (row >= BG) continue;
    const size_t bn = base + static_cast<size_t>(row / G) * NH + h * G + row % G;
    if (tig == 0) {
      m_out[bn] = m_r[r] > 0.5f * NEG_INF ? m_r[r] * LN2 : NEG_INF;
      l_out[bn] = l;
    }
    float* dst = acc_out + bn * DH + 2 * tig;
#pragma unroll
    for (int n = 0; n < ONB; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// partial carries [S, BN(, DH)] -> one carry [BN(, DH)]; one thread per
// 4 columns of a row, each partial read once as a 16-byte vector
template <int DH>
__global__ void __launch_bounds__(256) prefix_carry_combine(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float4* __restrict__ acc_part, float* __restrict__ m_out,
    float* __restrict__ l_out, float4* __restrict__ acc_out, int S, int BN)
{
  constexpr int V = DH / 4;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= BN * V) return;
  const int bn = i / V, c = i % V;
  float m = NEG_INF;
  for (int s = 0; s < S; ++s) m = fmaxf(m, m_part[static_cast<size_t>(s) * BN + bn]);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const size_t j = static_cast<size_t>(s) * BN + bn;
    const float w = __expf(m_part[j] - m);  // 1 for an all-empty row: l, acc are 0
    const float4 x = acc_part[j * V + c];
    l += w * l_part[j];
    a.x += w * x.x; a.y += w * x.y; a.z += w * x.z; a.w += w * x.w;
  }
  acc_out[static_cast<size_t>(bn) * V + c] = a;
  if (c == 0) { m_out[bn] = m; l_out[bn] = l; }
}

template <int DH>
int launch(const void* q, const void* kp, const void* vp, const void* pages,
           const void* pfx_len, const void* q_pos, void* m0, void* l0, void* acc0,
           void* m_part, void* l_part, void* acc_part, int B, int NH, int KVH, int PS,
           int Pp, int window, int tiles_per_split, int n_split, float scale,
           cudaStream_t stream)
{
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = prefix_carry_kernel<DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int G = NH / KVH;
  const bool split = n_split > 1;
  kern<<<dim3(KVH, (B * G + QT - 1) / QT, n_split), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int32_t*>(pages),
      static_cast<const int32_t*>(pfx_len), static_cast<const int32_t*>(q_pos),
      static_cast<float*>(split ? m_part : m0), static_cast<float*>(split ? l_part : l0),
      static_cast<float*>(split ? acc_part : acc0), B, NH, KVH, PS, Pp, window,
      tiles_per_split, scale * LOG2E);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return static_cast<int>(e);
  const int BN = B * NH, n4 = BN * (DH / 4);
  prefix_carry_combine<DH><<<(n4 + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float4*>(acc_part), static_cast<float*>(m0), static_cast<float*>(l0),
      static_cast<float4*>(acc0), n_split, BN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Split s covers tiles [s * tiles_per_split, (s + 1) * tiles_per_split)
// of the prefix. n_split > 1 needs m_part/l_part [n_split, B, NH] and
// acc_part [n_split, B, NH, Dh] f32 scratch; with n_split == 1 they may
// be null.
extern "C" int prefix_carry_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* pfx_pages,
    const void* pfx_len, const void* q_pos, void* m0, void* l0, void* acc0,
    void* m_part, void* l_part, void* acc_part, int B, int NH, int KVH, int Dh, int PS,
    int Pp, int window, int tiles_per_split, int n_split, float scale, void* stream)
{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (n_split < 1 || tiles_per_split < 1 || Pp < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto dh) {
    return launch<decltype(dh)::value>(q, k_pages, v_pages, pfx_pages, pfx_len, q_pos, m0, l0,
                                       acc0, m_part, l_part, acc_part, B, NH, KVH, PS, Pp,
                                       window, tiles_per_split, n_split, scale, s);
  };
  switch (Dh) {
    case 64: return go(std::integral_constant<int, 64>());
    case 128: return go(std::integral_constant<int, 128>());
    case 256: return go(std::integral_constant<int, 256>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


