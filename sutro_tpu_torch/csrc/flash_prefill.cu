// Causal flash prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_flash.py::flash_prefill (kernel body
// _flash_kernel). Self-attention over a chunk with no past: query and
// key positions are [0, T). GQA (query head n reads KV head n / G),
// causal mask, per-layer sliding window that skips whole key tiles, and
// the attention sink joining the denominator at finalize. f32 softmax
// and accumulation; NEG_INF is -1e30 as in the reference.
//
// What bounds it on this card: a row of T tokens costs 4 * T^2/2 * Dh
// flops per query head against 2 * T * Dh * 2 bytes of Q and O per head
// (and a quarter or eighth of that for K and V). At the serve's 8 x 500
// (NH=32, Dh=128) the bytes bound it, just: 82 MB take 0.025 ms at
// 3.35 TB/s, the 16.4 GFLOP 0.017 ms at the dense bf16 peak; from ~1k
// tokens on the products do (4 x 2,048: 0.139 ms of products).
//
// What the design does about it (FlashAttention-2 on the tensor cores):
// one block of 4 warps per (query tile, query head, row); each warp owns
// MT m16 tiles of 16 query rows (MT = 1: a 64-row query tile; MT = 2 for
// chunks of 1,024 tokens or more at Dh=128, where every K or V fragment
// loaded from shared memory then feeds two products). Both products,
// S = Q K^T and O += P V, run as mma.sync.m16n8k16 bf16 with f32
// accumulators, their fragments loaded with ldmatrix (.trans for V) from
// rows padded by 16 bytes, so the eight row addresses of an 8 x 8
// matrix fall in distinct banks. The scores and p never leave
// registers: the S accumulator fragment is scaled by Dh^-0.5 in f32
// (after the product, as the reference does), masked, exponentiated and
// repacked as the A operand of P V; the running max is reduced across
// the four lanes of a quad with shuffles, and m and l stay per row in
// registers (l as per-lane partial sums, reduced once at the end). p
// enters P V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
// which keeps ~16 bits of the reference's f32 p: with one bf16 p the
// kernel stayed inside its 2e-2 check, but a 48-layer MoE model's
// prefill logits moved from ~4e-2 to ~5e-2 relative L2 against the
// plain forward, at the edge of that check's 5e-2. K/V tiles are
// double-buffered with cp.async, so tile k+1 streams in while tile k is
// multiplied. Only the tiles that cross the diagonal, the window's edge
// or the chunk's end are masked; key tiles above the diagonal or wholly
// before the window are never loaded. Query tiles run from the last
// (the longest key range) to the first.
//
// mma.sync, not wgmma: with 16 query rows per m tile the score fragment
// is exactly the A operand of P V, so p goes from the softmax to the
// second product without a trip through shared memory; wgmma would need
// shared-memory descriptors with a swizzled layout for K and V and a
// 64-row warpgroup tile.
//
// With one m tile and Dh <= 128, Q goes to registers once and is staged
// in stage 1's K rows, so a block needs shared memory for the K/V ring
// only and three blocks (12 warps) share an SM; the register budget is
// capped at 168 to match.
//
// What still holds it back: mma.sync issues from one warp at a time and
// waits on its operands, and 12 warps an SM hide the latency of the
// products, the ldmatrix loads and the softmax only in part; the hi +
// lo split adds half again to the products; each warp reads the whole
// K and V tile from shared memory; at 500 tokens ~15% of the products
// are on masked keys of the diagonal tiles. A deeper cp.async ring and
// 32-key tiles measured no faster; skipping a warp's masked key blocks
// in the diagonal tiles, or scaling the raw max and fusing the scale
// into the exponent, measured slower. wgmma with TMA-fed,
// warp-specialised stages is the next step. Dh=256 takes 32-key tiles
// and reads the Q fragments from shared memory each tile, to stay
// inside the register budget.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;  // K/V tiles in flight (more measured no faster)

// MT m16 tiles (16 query rows each) per warp: a block holds 16 * MT * 4
// query rows, and every K or V fragment loaded from shared memory feeds
// MT products
// Q goes to registers when it fits (one m tile, Dh <= 128): it is then
// staged in stage 1's K rows and needs no shared memory of its own,
// which leaves room for three blocks an SM
template <int DH, int MT>
__host__ __device__ constexpr bool q_in_registers() { return MT == 1 && DH <= 128; }

template <int DH, int BK, int MT>
constexpr size_t smem_bytes() {  // [Q tile,] then STAGES stages of (K, V)
  return size_t((q_in_registers<DH, MT>() ? 0 : 16 * MT * WARPS) + 2 * STAGES * BK)
         * (DH + 8) * sizeof(__nv_bfloat16);
}

template <int DH, int BK, int MT>
__global__ void __launch_bounds__(THREADS, q_in_registers<DH, MT>() ? 3 : 1) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, T, NH, DH]
    const __nv_bfloat16* __restrict__ k,   // [B, T, KVH, DH]
    const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ sink,        // [NH] or null
    __nv_bfloat16* __restrict__ out,       // [B, T, NH, DH]
    int T, int NH, int KVH, int window, float scale_log2)
{
  constexpr int BQ = 16 * MT * WARPS;  // query rows per block
  constexpr int ROW = DH + 8;          // padded bf16 row
  constexpr int VEC = DH / 8;          // 16-byte chunks per row
  constexpr int KSTEPS = DH / 16;      // k-steps of Q K^T
  constexpr int NB = BK / 8;           // 8-key score blocks
  constexpr int ONB = DH / 8;          // 8-column output blocks
  constexpr bool Q_REGS = q_in_registers<DH, MT>();
  static_assert(!Q_REGS || BK == BQ, "Q is staged in a K tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem_raw) + (Q_REGS ? 0 : BQ * ROW);
  // stage st: K at 2*st, V at 2*st+1 (BK rows each); Q in its own rows,
  // or in stage 1's K rows until it is in registers
  __nv_bfloat16* Qs = Q_REGS ? KVs + 2 * BK * ROW : reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int hq = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int G = NH / KVH, hk = hq / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;

  // key tiles: causal end at the tile's last query, window start at its
  // first query's oldest in-window key
  const int k_hi = min(q0 + BQ, T);
  int k_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) k_lo = (q0 - window + 1) / BK * BK;
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  const size_t q_stride = size_t(NH) * DH, kv_stride = size_t(KVH) * DH;
  const __nv_bfloat16* qb = q + size_t(b) * T * q_stride + size_t(hq) * DH;
  const __nv_bfloat16* kb = k + size_t(b) * T * kv_stride + size_t(hk) * DH;
  const __nv_bfloat16* vb = v + size_t(b) * T * kv_stride + size_t(hk) * DH;

  for (int c = tid; c < BQ * VEC; c += THREADS) {  // rows past T are zero
    const int r = c / VEC, col = c % VEC;
    const bool ok = q0 + r < T;
    cp_async16(Qs + r * ROW + col * 8, qb + size_t(ok ? q0 + r : 0) * q_stride + col * 8, ok);
  }
  auto load_kv = [&](int tile, int st) {
    const int k0 = k_lo + tile * BK;
    __nv_bfloat16* Ks = KVs + (2 * st) * BK * ROW;
    __nv_bfloat16* Vs = Ks + BK * ROW;
    for (int c = tid; c < BK * VEC; c += THREADS) {
      const int r = c / VEC, col = c % VEC;
      const bool ok = k0 + r < T;  // rows past T are zero, so 0 * p adds no NaN
      const size_t off = size_t(ok ? k0 + r : 0) * kv_stride + col * 8;
      cp_async16(Ks + r * ROW + col * 8, kb + off, ok);
      cp_async16(Vs + r * ROW + col * 8, vb + off, ok);
    }
  };
  // the ring: tiles 0 .. STAGES-2 in flight before the loop (Q with tile 0)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i, i);
    cp_async_commit();
  }

  const __nv_bfloat16* Qw = Qs + warp * 16 * MT * ROW;  // this warp's 16 * MT query rows
  uint32_t qf[Q_REGS ? KSTEPS : 1][4];
  float o[MT][ONB][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < ONB; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
  // rows gid and gid+8 of each m tile: running max (log2 units) and this
  // lane's partial sum of p
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) m_r[m][0] = m_r[m][1] = NEG_INF, l_r[m][0] = l_r[m][1] = 0.f;
  const int qr = q0 + warp * 16 * MT + gid;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    cp_async_wait<STAGES - 2>();  // this tile (and Q) has landed
    __syncthreads();              // ... for every thread; and the stage freed
                                  // by the last iteration is read by no one
    if constexpr (Q_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldsm_x4(qf[kk], Qw + (lane & 15) * ROW + kk * 16 + (lane >> 4) * 8);
        __syncthreads();  // Q's rows are the next copy's target
      }
    }
    const int nxt = it + STAGES - 1;
    if (nxt < n_tiles) load_kv(nxt, nxt % STAGES);
    cp_async_commit();
    const __nv_bfloat16* Ks = KVs + (2 * st) * BK * ROW;
    const __nv_bfloat16* Vs = Ks + BK * ROW;
    const int k0 = k_lo + it * BK;

    // S = Q K^T: 16 * MT rows x BK keys per warp
    float s[MT][NB][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NB; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (Q_REGS) {
          a[m][0] = qf[kk][0]; a[m][1] = qf[kk][1]; a[m][2] = qf[kk][2]; a[m][3] = qf[kk][3];
        } else {
          ldsm_x4(a[m], Qw + (m * 16 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int j = 0; j < NB; j += 2) {  // two 8-key blocks per ldmatrix.x4
        uint32_t bk[4];
        ldsm_x4(bk, Ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * ROW + kk * 16
                        + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(s[m][j], a[m], bk[0], bk[1]);
          mma_bf16(s[m][j + 1], a[m], bk[2], bk[3]);
        }
      }
    }

    // scale in f32, mask the tiles that need it
    const bool masked = k0 + BK - 1 > q0 || k0 + BK > T ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
    uint32_t ph[MT][NB][2], pl[MT][NB][2];  // p as bf16 hi + lo pairs: rows gid, gid+8
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[m][j][e] * scale_log2;
          if (masked) {
            const int kp = k0 + j * 8 + 2 * tig + (e & 1);
            const int qp = qr + m * 16 + (e >> 1) * 8;
            const bool ok = kp <= qp && kp < T && (window <= 0 || qp - kp < window);
            x = ok ? x : NEG_INF;
          }
          s[m][j][e] = x;
        }

      // online softmax: row max over the quad, p under the mask
      float mx[2] = {m_r[m][0], m_r[m][1]};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[m][j][0], s[m][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[m][j][2], s[m][j][3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2(m_r[m][r] - mx[r]);
        m_r[m][r] = mx[r];
        l_r[m][r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[m][j][e], mr = mx[e >> 1];
          p[e] = (!masked || x > 0.5f * NEG_INF) ? fast_exp2(x - mr) : 0.f;
        }
        l_r[m][0] += p[0] + p[1];
        l_r[m][1] += p[2] + p[3];
        split_bf16(p[0], p[1], ph[m][j][0], pl[m][j][0]);
        split_bf16(p[2], p[3], ph[m][j][1], pl[m][j][1]);
      }
#pragma unroll
      for (int n = 0; n < ONB; ++n) {
        o[m][n][0] *= alpha[0]; o[m][n][1] *= alpha[0];
        o[m][n][2] *= alpha[1]; o[m][n][3] *= alpha[1];
      }
    }

    // O += P V: the score fragment is the A operand as it stands; p's
    // hi and lo terms share each V fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < ONB; n += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW + n * 8
                          + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t ah[4] = {ph[m][2 * kk][0], ph[m][2 * kk][1], ph[m][2 * kk + 1][0],
                                  ph[m][2 * kk + 1][1]};
          const uint32_t al[4] = {pl[m][2 * kk][0], pl[m][2 * kk][1], pl[m][2 * kk + 1][0],
                                  pl[m][2 * kk + 1][1]};
          mma_bf16(o[m][n], ah, bv[0], bv[1]);
          mma_bf16(o[m][n + 1], ah, bv[2], bv[3]);
          mma_bf16(o[m][n], al, bv[0], bv[1]);
          mma_bf16(o[m][n + 1], al, bv[2], bv[3]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with Q and the stages

  // finalize: l over the quad; the sink is one more logit in the
  // denominator. Each warp stages its bf16 rows in its own Q rows (stage
  // 0's K rows when Q lived in registers), then stores them 16 bytes at a
  // time.
  __nv_bfloat16* Ow = (Q_REGS ? KVs : Qs) + warp * 16 * MT * ROW;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[m][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      float a = 1.f;
      if (sink != nullptr) {
        const float sk = sink[hq] * LOG2E;
        const float mn = fmaxf(m_r[m][r], sk);
        a = fast_exp2(m_r[m][r] - mn);
        l = l * a + fast_exp2(sk - mn);
      }
      f[r] = a / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < ONB; ++n) {
      *reinterpret_cast<uint32_t*>(Ow + (m * 16 + gid) * ROW + n * 8 + 2 * tig) =
          pack_bf16(o[m][n][0] * f[0], o[m][n][1] * f[0]);
      *reinterpret_cast<uint32_t*>(Ow + (m * 16 + gid + 8) * ROW + n * 8 + 2 * tig) =
          pack_bf16(o[m][n][2] * f[1], o[m][n][3] * f[1]);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * MT * VEC; c += 32) {
    const int r = c / VEC, col = c % VEC, qp = q0 + warp * 16 * MT + r;
    if (qp < T)
      *reinterpret_cast<uint4*>(out + (size_t(b) * T + qp) * q_stride + size_t(hq) * DH
                                + col * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * ROW + col * 8);
  }
}

template <int DH, int BK, int MT>
int launch(const void* q, const void* k, const void* v, const void* sink, void* out,
           int B, int T, int NH, int KVH, int window, float scale, cudaStream_t stream)
{
  constexpr size_t smem = smem_bytes<DH, BK, MT>();
  constexpr int BQ = 16 * MT * WARPS;
  auto kern = flash_prefill_kernel<DH, BK, MT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(NH, (T + BQ - 1) / BQ, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(sink),
      static_cast<__nv_bfloat16*>(out), T, NH, KVH, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, const void* sink, void* out,
    int B, int T, int NH, int KVH, int Dh, int window, float scale, void* stream)
{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch<64, 64, 1>(q, k, v, sink, out, B, T, NH, KVH, window, scale, s);
    case 128:  // long chunks: two m tiles a warp (measured faster from ~1k tokens)
      if (T >= 1024) return launch<128, 64, 2>(q, k, v, sink, out, B, T, NH, KVH, window, scale, s);
      return launch<128, 64, 1>(q, k, v, sink, out, B, T, NH, KVH, window, scale, s);
    case 256: return launch<256, 32, 1>(q, k, v, sink, out, B, T, NH, KVH, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
