// Grouped matmul (MoE expert GEMM) for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_gmm.py::grouped_matmul (kernel body
// _gmm_kernel). out[i] = lhs[i] @ rhs[g(i)] for rows sorted by group, the
// contract of jax.lax.ragged_dot: lhs [M, H] bf16, rhs [E, H, F] bf16,
// group_sizes [E] int32 (sum <= M; empty groups allowed), out [M, F] bf16,
// f32 accumulation; rows past the last group are zero.
//
// What bounds it on this card: at decode sizes (M = B * top_k = 512
// rows over ~126 of 128 experts) bytes: every routed expert's [H, F]
// weights are read once for a handful of rows. At prefill sizes (M in
// the tens of thousands, hundreds of rows per expert) operations: the
// tensor cores.
//
// What the design does about it: the group sizes stay on the device.
// The grid has the static row-tile bound ceil(M / BM) + E (each group
// adds at most one partial tile); warp 0 of each block scans the
// device-side group sizes to find its expert, its first row and its row
// count, and a block past the last tile zeroes up to BM rows past the last
// group and exits. So a tile never spans two
// experts, no host wait is needed to size the launch, and one block
// column reads a [H, BN] weight slab once for all the tile's rows. The
// products run on the tensor cores (nvcuda::wmma 16x16x16 bf16, f32
// accumulators) from a cp.async double buffer in shared memory. A
// small-M decode tiling (fewer idle rows per expert) and wgmma/TMA are
// left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;               // rows of a tile (one expert's rows)
constexpr int BN = 128;              // output columns of a tile
constexpr int BK = 32;               // depth of one pipeline stage
constexpr int THREADS = 128;         // 4 warps in a 2 x 2 grid of 32 x 64
constexpr int LDA = BK + 8;          // padded smem rows (bf16 elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;          // epilogue staging (f32 elements)
constexpr int A_STAGE = BM * LDA;    // bf16 elements of one A stage
constexpr int B_STAGE = BK * LDB;
constexpr int PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0 => the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__global__ void __launch_bounds__(THREADS) grouped_matmul_kernel(
    const __nv_bfloat16* __restrict__ lhs,      // [M, H]
    const __nv_bfloat16* __restrict__ rhs,      // [E, H, F]
    const int32_t* __restrict__ group_sizes,    // [E]
    __nv_bfloat16* __restrict__ out,            // [M, F]
    int M, int H, int F, int E)
{
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int tile_info[3];  // expert, first row, rows (expert < 0: none)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = blockIdx.x;

  // -- which expert and rows this tile is, from the device-side sizes
  if (warp == 0) {
    int tile_base = 0, row_base = 0;
    bool found = false;
    for (int e0 = 0; e0 < E && !found; e0 += 32) {
      const int e = e0 + lane;
      const int gs = e < E ? max(group_sizes[e], 0) : 0;
      const int nt = (gs + BM - 1) / BM;
      int ct = nt, cr = gs;  // inclusive scans over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, ct, o);
        const int b = __shfl_up_sync(0xffffffffu, cr, o);
        if (lane >= o) { ct += a; cr += b; }
      }
      const int first_tile = tile_base + ct - nt;
      const bool mine = nt > 0 && t >= first_tile && t < tile_base + ct;
      const unsigned hit = __ballot_sync(0xffffffffu, mine);
      if (hit) {
        if (mine) {
          const int r0 = row_base + cr - gs + (t - first_tile) * BM;
          tile_info[0] = e;
          tile_info[1] = r0;
          tile_info[2] = max(0, min(min(BM, gs - (t - first_tile) * BM), M - r0));
        }
        found = true;
      }
      tile_base += __shfl_sync(0xffffffffu, ct, 31);
      row_base += __shfl_sync(0xffffffffu, cr, 31);
    }
    if (!found && lane == 0) {
      // past the last tile: block t - tiles zeroes the rows past the last
      // group, BM at a time (the grid bound leaves enough such blocks)
      const int r0 = row_base + (t - tile_base) * BM;
      tile_info[0] = -1;
      tile_info[1] = r0;
      tile_info[2] = max(0, min(BM, M - r0));
    }
  }
  __syncthreads();
  const int expert = tile_info[0];
  const int row0 = tile_info[1], rows = tile_info[2];
  const int n0 = blockIdx.y * BN;
  if (expert < 0) {  // uniform exit, after the zeros of rows past the groups
    for (int c = tid; c < rows * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      if (n0 + nc < F)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * F + n0 + nc) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + 2 * A_STAGE;
  const __nv_bfloat16* w = rhs + static_cast<size_t>(expert) * H * F;

  // one stage: A [BM, BK] (2 x 16 B per thread), B [BK, BN] (4 x 16 B)
  auto load_stage = [&](int k0, int stage) {
    __nv_bfloat16* as = a_s + stage * A_STAGE;
    __nv_bfloat16* bs = b_s + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < H;
      const __nv_bfloat16* src = ok ? lhs + static_cast<size_t>(row0 + r) * H + k0 + kc : lhs;
      cp_async16(as + r * LDA + kc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < H && n0 + nc < F;
      const __nv_bfloat16* src = ok ? w + static_cast<size_t>(k0 + r) * F + n0 + nc : w;
      cp_async16(bs + r * LDB + nc, src, ok);
    }
    cp_async_commit();
  };

  const int wm = warp / 2, wn = warp % 2;  // warp tile: rows wm*32, cols wn*64
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (H + BK - 1) / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) * BK, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = a_s + (kt & 1) * A_STAGE;
    const __nv_bfloat16* bs = b_s + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next load overwrites this stage
  }

  // -- epilogue: stage the f32 tile in shared memory, write bf16 rows
  float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(c_s + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < BM * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    if (r >= rows || n0 + nc >= F) continue;
    const float* src = c_s + r * LDC + nc;
    __align__(16) __nv_bfloat162 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * F + n0 + nc) =
        *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

extern "C" int grouped_matmul_bf16(
    const void* lhs, const void* rhs, const void* group_sizes, void* out,
    int M, int H, int F, int E, void* stream)
{
  if (M <= 0) return 0;
  if (H % 8 || F % 8 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM + E, (F + BN - 1) / BN);
  grouped_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs),
      static_cast<const int32_t*>(group_sizes), static_cast<__nv_bfloat16*>(out),
      M, H, F, E);
  return static_cast<int>(cudaGetLastError());
}
