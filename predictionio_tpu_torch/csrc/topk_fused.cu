// Fused int8 score -> mask -> per-tile top-k, written by hand for Hopper
// (sm_90a). Built by predictionio_tpu_torch/ops/_kernels.py with nvcc into
// a shared library with a plain C interface, bound with ctypes by
// predictionio_tpu_torch/ops/topk_fused.py.
//
// Replaces predictionio_tpu/ops/topk_pallas.py::_score_mask_topk_kernel
// (wrapper topk_for_users_quant_fused). For each item tile of `tile`
// columns and each query row it computes the exact int32 dot products of
// the row's int8 user factors with the tile's int8 item columns, rescales
// them as float32(s32) * (su * sv), masks the layout padding (global
// column >= n_items) to -3.4e38, and extracts min(k, tile) candidates by
// repeated (row max, lowest global index at that max), masking each
// winner. Only the candidates leave the chip; the wrapper merges the
// n_tiles * k_local candidates of a row with a stable sort.
//
// What bounds it on the H100: at the serving shape (b <= 64 rows, r = 10,
// 53 tiles of 512) the kernel reads ~0.3 MB and writes <= 0.3 MB, under a
// microsecond at 3.35 TB/s, and its integer work is far below the int8
// peak. Launch latency and the k_local serial selection rounds set its
// time, so the design keeps everything after the loads on chip:
//   * The TPU grid ran the tiles in order on one core; here one block owns
//     one (item tile, chunk of 8 query rows) pair and blocks run in any
//     order, since tiles are independent.
//   * Hopper has no scalar prefetch: the block gathers its own user rows
//     (u_q[user_ixs[row]]) and scales, and stages the (r, tile) int8 slice
//     and the tile's scales in shared memory once for its 8 rows.
//   * One warp per query row; each lane holds tile/32 scores and their
//     global indices in registers. A selection round is a lane-local scan
//     plus a 5-step butterfly shuffle on the key (value descending, index
//     ascending), after which every lane knows the winner and its owner
//     masks it. No shared memory or barrier inside the rounds.
//
// Bit-identity with the reference (finite factors): the dot is exact in
// int32, the rescale multiplies su * sv first and then the converted sum,
// each rounded to nearest with no contraction (__fmul_rn), the mask value
// is exactly -3.4e38f, and the key order is the reference's total order,
// including its repeats of the lowest masked index once a tile runs out
// of real columns (k_local > real columns of the last tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // query rows per block, one warp each
constexpr float kNegInf = -3.4e38f;     // ops/topk.py NEG_INF, bit for bit
constexpr int kIMax = 0x7fffffff;

__device__ __forceinline__ bool better(float v1, int g1, float v2, int g2) {
  return v1 > v2 || (v1 == v2 && g1 < g2);
}

template <int PER_LANE>
__global__ void __launch_bounds__(kWarps * 32)
score_mask_topk(const int8_t* __restrict__ u_q,
                const float* __restrict__ u_scale,
                const int8_t* __restrict__ vt_q,
                const float* __restrict__ v_scale,
                const int32_t* __restrict__ user_ixs,
                float* __restrict__ out_vals,
                int32_t* __restrict__ out_idx,
                int b, int r, int n_pad, int tile, int k_local,
                int n_items) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv_s = reinterpret_cast<float*>(smem);             // [tile]
  int8_t* q_s = reinterpret_cast<int8_t*>(sv_s + tile);      // [kWarps][r]
  int8_t* vt_s = q_s + kWarps * r;                           // [r][tile]

  const int t = blockIdx.x;
  const int row0 = blockIdx.y * kWarps;
  const int col0 = t * tile;
  const int tid = threadIdx.x;

  for (int c = tid; c < tile; c += blockDim.x) sv_s[c] = v_scale[col0 + c];
  for (int i = tid; i < r * tile; i += blockDim.x) {
    const int rr = i / tile;
    const int c = i - rr * tile;
    vt_s[i] = vt_q[static_cast<size_t>(rr) * n_pad + col0 + c];
  }
  for (int i = tid; i < kWarps * r; i += blockDim.x) {
    const int w = i / r;
    const int row = row0 + w;
    q_s[i] = row < b
        ? u_q[static_cast<size_t>(user_ixs[row]) * r + (i - w * r)]
        : int8_t(0);
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = row0 + warp;
  if (row >= b) return;
  const float su = u_scale[user_ixs[row]];
  const int8_t* q = q_s + warp * r;

  float s[PER_LANE];
  int g[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int c = lane + 32 * j;
    if (c < tile) {
      int acc = 0;
      for (int rr = 0; rr < r; ++rr) {
        acc += static_cast<int>(q[rr]) * static_cast<int>(vt_s[rr * tile + c]);
      }
      const int gid = col0 + c;
      const float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(su, sv_s[c]));
      s[j] = gid < n_items ? v : kNegInf;
      g[j] = gid;
    } else {
      // past the tile's last column: below every entry, never selected
      // (k_local <= tile)
      s[j] = __int_as_float(0xff800000);  // -inf
      g[j] = kIMax;
    }
  }

  const size_t out0 = static_cast<size_t>(row) * gridDim.x * k_local
      + static_cast<size_t>(t) * k_local;
  for (int round = 0; round < k_local; ++round) {
    float bv = s[0];
    int bg = g[0];
#pragma unroll
    for (int j = 1; j < PER_LANE; ++j) {
      if (better(s[j], g[j], bv, bg)) {
        bv = s[j];
        bg = g[j];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int og = __shfl_xor_sync(0xffffffffu, bg, off);
      if (better(ov, og, bv, bg)) {
        bv = ov;
        bg = og;
      }
    }
    if (lane == 0) {
      out_vals[out0 + round] = bv;
      out_idx[out0 + round] = bg;
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (g[j] == bg) s[j] = kNegInf;
    }
  }
}

template <int PER_LANE>
cudaError_t launch(const int8_t* u_q, const float* u_scale,
                   const int8_t* vt_q, const float* v_scale,
                   const int32_t* user_ixs, float* out_vals,
                   int32_t* out_idx, int b, int r, int n_pad, int tile,
                   int k_local, int n_items, cudaStream_t stream) {
  const dim3 grid(n_pad / tile, (b + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(tile) * sizeof(float)
      + static_cast<size_t>(kWarps) * r + static_cast<size_t>(r) * tile;
  score_mask_topk<PER_LANE><<<grid, kWarps * 32, smem, stream>>>(
      u_q, u_scale, vt_q, v_scale, user_ixs, out_vals, out_idx,
      b, r, n_pad, tile, k_local, n_items);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest tile the register layout holds (32 lanes x 32 scores).
int pio_topk_fused_max_tile() { return 32 * 32; }

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the 48 KB a launch gets without opting in.
int pio_topk_fused_smem_bytes(int r, int tile) {
  return tile * static_cast<int>(sizeof(float)) + kWarps * r + r * tile;
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Candidates land in out_vals / out_idx, (b, n_pad / tile * k_local) row
// major, tile-major within a row.
int pio_topk_fused_candidates(const void* u_q, const void* u_scale,
                              const void* vt_q, const void* v_scale,
                              const void* user_ixs, void* out_vals,
                              void* out_idx, int b, int r, int n_pad,
                              int tile, int k_local, int n_items,
                              void* stream) {
  const auto* uq = static_cast<const int8_t*>(u_q);
  const auto* us = static_cast<const float*>(u_scale);
  const auto* vq = static_cast<const int8_t*>(vt_q);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ix = static_cast<const int32_t*>(user_ixs);
  auto* ov = static_cast<float*>(out_vals);
  auto* oi = static_cast<int32_t*>(out_idx);
  auto st = static_cast<cudaStream_t>(stream);
  const int per_lane = (tile + 31) / 32;
  if (per_lane <= 1) return launch<1>(uq, us, vq, vs, ix, ov, oi, b, r, n_pad, tile, k_local, n_items, st);
  if (per_lane <= 2) return launch<2>(uq, us, vq, vs, ix, ov, oi, b, r, n_pad, tile, k_local, n_items, st);
  if (per_lane <= 4) return launch<4>(uq, us, vq, vs, ix, ov, oi, b, r, n_pad, tile, k_local, n_items, st);
  if (per_lane <= 8) return launch<8>(uq, us, vq, vs, ix, ov, oi, b, r, n_pad, tile, k_local, n_items, st);
  if (per_lane <= 16) return launch<16>(uq, us, vq, vs, ix, ov, oi, b, r, n_pad, tile, k_local, n_items, st);
  if (per_lane <= 32) return launch<32>(uq, us, vq, vs, ix, ov, oi, b, r, n_pad, tile, k_local, n_items, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
