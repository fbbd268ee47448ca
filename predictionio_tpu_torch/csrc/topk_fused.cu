// Fused int8 score -> mask -> per-tile top-k, and the merge of the tiles'
// candidates, written by hand for Hopper (sm_90a). Built by
// predictionio_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface, bound with ctypes by
// predictionio_tpu_torch/ops/topk_fused.py, which launches the two kernels
// one after the other on the current stream.
//
// Kernel B1, score_mask_topk, replaces the TPU kernel
// predictionio_tpu/ops/topk_pallas.py:94 (_score_mask_topk_kernel). For
// each item tile of `tile` columns and each query row it computes the exact
// int32 dot products of the row's int8 user factors with the tile's int8
// item columns, rescales them as float32(s32) * (su * sv), masks the layout
// padding (global column >= n_items) to -3.4e38 and extracts
// k_local = min(k, tile) candidates by repeated (row max, lowest global
// index at that max), masking each winner. Output: (b, n_tiles * k_local)
// values and global indices, tile-major, each tile's list in the order it
// was extracted.
//
// Kernel B2, merge_tile_lists, replaces the two-key lax.sort merge at
// predictionio_tpu/ops/topk_pallas.py:180 (which ran outside the Pallas
// call). One warp per query row merges the row's n_tiles lists into the
// first min(k, n_tiles * k_local) entries of the (value descending, index
// ascending) order.
//
// What bounds them on the H100. At the serving shape (b <= 64 rows, r = 10,
// 53 tiles of 512, k = 10) B1 reads about 0.3 MB and does 17.4 M int8
// multiply-adds; B2 reads the candidates (at most 0.3 MB) and writes b * k
// pairs. Either is well under a microsecond of the card's bytes or
// operations. Their time is latency: the dependent memory round trips
// before the first score and the serial warp steps of the k selection or
// merge rounds. So the design cuts round trips and steps, not bytes:
//   * B1 loads each lane's columns with 16-byte loads straight into
//     registers (tile 512: a lane owns 16 contiguous columns and reads one
//     int4 per rank row and four float4 of scales), all issued before the
//     first use; no shared memory, no barrier, no per-byte loop and no
//     integer divide. A tile of another width than 128, 256, 512 or 1024
//     columns (tile 100, say) takes a byte-wise load path in the same
//     kernel.
//   * The dot products run on __dp4a: a 4x4 byte transpose (__byte_perm)
//     turns four rank rows of four columns into one word per column, and
//     the user row is packed four rank rows to a word, zero past r. The
//     int32 sums are exact.
//   * A selection round is two warp reductions: __reduce_max_sync of an
//     order-preserving 32-bit key of each lane's cached best value, then
//     __reduce_min_sync of the global indices of the lanes holding that key.
//     Only the winning lane writes the pair, masks its entry and rescans its
//     own columns; no shuffles, no shared memory.
//   * B2 keeps, in each lane, the head and the next entry of each list it
//     owns (lists lane * L .. lane * L + L - 1). A round is one
//     __reduce_max_sync of the head keys and one ballot of the lanes
//     holding the top key: lower lanes own lower tiles, whose indices are
//     all lower, so the lowest such lane holds the lowest index at that
//     key. The winning lane writes the pair, moves its next entry up to
//     the head and issues the load of the one after, which the list does
//     not need until it wins again. Large k (up to the whole catalog)
//     runs the same loop for k rounds. A row of more than 1,024 lists (a
//     catalog above 524,288 items at tile 512) takes merge_tile_lists_wide:
//     the same rounds, with each list's head key and position in shared
//     memory (up to 6,144 lists) or in a global workspace the caller
//     passes (any number), and the winner rescanning its lane's heads
//     there. No catalog size is refused.
//   * On the H100 B1's ten selection rounds at k = 10 take about as long
//     as its loads and dot products (chip_smoke.py times the body at
//     k_local 1 and 10). Staging the tile in shared memory with cp.async, a max tree
//     for the rescan and a ballot in place of B1's second reduction did
//     not make B1 faster there, so B1 keeps this plain form.
//   * Tensor cores, wgmma and TMA are not used: the whole product is
//     b x 10 x 27,136 int8 multiply-adds, a few wgmma tiles' worth, and a
//     tile slice is 5 KB; their set-up (descriptors, barriers, staging
//     through shared memory) would add steps to a kernel whose time is
//     steps.
//
// Bit-identity with the reference (finite factors): the dot is exact in
// int32, the rescale multiplies su * sv first and then the converted sum,
// each rounded to nearest with no contraction (__fmul_rn), and the mask
// value is exactly -3.4e38f. The key of a float is its bit pattern with the
// 31 magnitude bits flipped when the sign is set; as a signed int it orders
// like the float for every non-NaN value except that -0.0 sorts below +0.0.
// A score is never -0.0: the scales are positive (max|row| / 127, or 1.0
// for an all-zero row, ops/quant.py), so float32(s32) * (su * sv) is +0.0
// for s32 = 0 and nonzero otherwise, unless the product rounds to zero,
// which needs su * sv below 2^-150 (both scales below about 1e-22). So
// max-key-then-min-index selects exactly what the reference's (max,
// lowest index at the max) does, including its repeats of the tile's
// lowest masked index once a tile runs out of real columns (k_local >
// real columns of the last tile): the masked winner keeps -3.4e38 and
// stays a candidate. The key maps back to the value's exact bits for the
// output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                // query rows per B1 block, one warp each
constexpr int kMaxPerLane = 32;         // B1: columns a lane holds (tile <= 1024)
constexpr int kMaxListsPerLane = 32;    // B2: lists a lane holds in registers
constexpr int kMergeSmemBytes = 48 * 1024;  // B2 wide: heads in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -3.4e38f;     // ops/topk.py NEG_INF, bit for bit
constexpr int kIMax = 0x7fffffff;
constexpr int kNone = -0x7fffffff - 1;  // key below every float's key

// Order-preserving key of a float's bits, and its own inverse.
__device__ __forceinline__ int flip(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

__device__ __forceinline__ int key_of(float v) { return flip(__float_as_int(v)); }

__device__ __forceinline__ float value_of(int key) { return __int_as_float(flip(key)); }

// Words a, b, c, d hold four rank rows of the same four columns (byte e =
// column e). Returns in o[e] column e's four rank rows, row a in byte 0.
__device__ __forceinline__ void transpose4(unsigned a, unsigned b, unsigned c,
                                           unsigned d, unsigned* o) {
  const unsigned ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const unsigned ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const unsigned cd_lo = __byte_perm(c, d, 0x5140);
  const unsigned cd_hi = __byte_perm(c, d, 0x7362);
  o[0] = __byte_perm(ab_lo, cd_lo, 0x5410);           // a0 b0 c0 d0
  o[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  o[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  o[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// P int8 columns of one rank row, as P / 4 words, in the widest loads the
// width allows (P = 16: one 16-byte load).
template <int P>
__device__ __forceinline__ void load_words(const int8_t* p, unsigned* w) {
  if constexpr (P % 16 == 0) {
#pragma unroll
    for (int m = 0; m < P / 16; ++m) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + m);
      w[4 * m] = v.x;
      w[4 * m + 1] = v.y;
      w[4 * m + 2] = v.z;
      w[4 * m + 3] = v.w;
    }
  } else if constexpr (P == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// B1. Block (tile, chunk of kRows query rows); warp = one row; lane owns the
// P contiguous columns [lane * P, lane * P + P) of the tile. VEC: the tile
// is exactly 32 * P columns, P a multiple of 4, and the rows are 16-byte
// aligned, so each rank row's slice is read with word-vector loads;
// otherwise byte loads, with the columns past the tile left out.
template <int P, bool VEC>
__global__ void __launch_bounds__(kRows * 32)
score_mask_topk(const int8_t* __restrict__ u_q,
                const float* __restrict__ u_scale,
                const int8_t* __restrict__ vt_q,
                const float* __restrict__ v_scale,
                const int32_t* __restrict__ user_ixs,
                float* __restrict__ out_vals,
                int32_t* __restrict__ out_idx,
                int b, int r, int n_pad, int tile, int k_local,
                int n_items) {
  constexpr int RC = P >= 32 ? 4 : 12;  // rank rows held in registers at once
  constexpr int NG = RC / 4;            // ... in words of four rows
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * kRows + (threadIdx.x >> 5);
  if (row >= b) return;
  const int t = blockIdx.x;
  const int col0 = t * tile;
  const int c0 = lane * P;
  const int ix = __ldg(user_ixs + row);
  const int8_t* vt = vt_q + col0 + c0;
  const int8_t* q = u_q + static_cast<size_t>(ix) * r;

  float sv[P];
  if constexpr (VEC) {
#pragma unroll
    for (int m = 0; m < P / 4; ++m) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(
          v_scale + col0 + c0) + m);
      sv[4 * m] = s4.x;
      sv[4 * m + 1] = s4.y;
      sv[4 * m + 2] = s4.z;
      sv[4 * m + 3] = s4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      sv[j] = c0 + j < tile ? __ldg(v_scale + col0 + c0 + j) : 0.f;
    }
  }

  int acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = 0;
  for (int r0 = 0; r0 < r; r0 += RC) {
    unsigned cw[NG][P];   // cw[g][j]: rank rows r0+4g .. r0+4g+3 of column j
    if constexpr (VEC) {
      unsigned w[RC][P / 4];
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        if (r0 + rr < r) {
          load_words<P>(vt + static_cast<size_t>(r0 + rr) * n_pad, w[rr]);
        } else {
#pragma unroll
          for (int m = 0; m < P / 4; ++m) w[rr][m] = 0u;
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int m = 0; m < P / 4; ++m) {
          transpose4(w[4 * g][m], w[4 * g + 1][m], w[4 * g + 2][m],
                     w[4 * g + 3][m], &cw[g][4 * m]);
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          unsigned word = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = r0 + 4 * g + e;
            if (rr < r && c0 + j < tile) {
              word |= static_cast<unsigned>(static_cast<uint8_t>(
                  __ldg(vt + static_cast<size_t>(rr) * n_pad + j))) << (8 * e);
            }
          }
          cw[g][j] = word;
        }
      }
    }
    unsigned qw[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      unsigned word = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r0 + 4 * g + e;
        if (rr < r) {
          word |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(q + rr)))
              << (8 * e);
        }
      }
      qw[g] = word;
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        acc[j] = __dp4a(static_cast<int>(cw[g][j]), static_cast<int>(qw[g]),
                        acc[j]);
      }
    }
  }

  const float su = __ldg(u_scale + ix);
  const int mask_key = key_of(kNegInf);
  int key[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int gid = col0 + c0 + j;
    const float s = __fmul_rn(__int2float_rn(acc[j]), __fmul_rn(su, sv[j]));
    key[j] = (!VEC && c0 + j >= tile) ? kNone
                                      : (gid < n_items ? key_of(s) : mask_key);
  }

  // the lane's best: highest key, lowest column among equal keys
  int bk = key[0], bj = 0;
#pragma unroll
  for (int j = 1; j < P; ++j) {
    if (key[j] > bk) {
      bk = key[j];
      bj = j;
    }
  }
  const size_t out0 = (static_cast<size_t>(row) * gridDim.x + t) * k_local;
  for (int round = 0; round < k_local; ++round) {
    const int top = __reduce_max_sync(kFull, bk);
    const int gid = col0 + c0 + bj;
    const int win = __reduce_min_sync(kFull, bk == top ? gid : kIMax);
    if (bk == top && gid == win) {
      out_vals[out0 + round] = value_of(top);
      out_idx[out0 + round] = win;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (j == bj) key[j] = mask_key;
      }
      bk = key[0];
      bj = 0;
#pragma unroll
      for (int j = 1; j < P; ++j) {
        if (key[j] > bk) {
          bk = key[j];
          bj = j;
        }
      }
    }
  }
}

template <int P, bool VEC>
cudaError_t launch_candidates(const int8_t* u_q, const float* u_scale,
                              const int8_t* vt_q, const float* v_scale,
                              const int32_t* user_ixs, float* out_vals,
                              int32_t* out_idx, int b, int r, int n_pad,
                              int tile, int k_local, int n_items,
                              cudaStream_t stream) {
  const dim3 grid(n_pad / tile, (b + kRows - 1) / kRows);
  const int rows = b < kRows ? b : kRows;
  score_mask_topk<P, VEC><<<grid, rows * 32, 0, stream>>>(
      u_q, u_scale, vt_q, v_scale, user_ixs, out_vals, out_idx,
      b, r, n_pad, tile, k_local, n_items);
  return cudaGetLastError();
}

// B2. One warp per query row; lane owns the L contiguous lists
// [lane * L, lane * L + L) (fewer past n_tiles). Each list is already in
// (key descending, index ascending) order, as B1 extracted it, and every
// index of tile t is below every index of tile t + 1.
template <int L>
__global__ void __launch_bounds__(32)
merge_tile_lists(const float* __restrict__ vals,
                 const int32_t* __restrict__ idx,
                 float* __restrict__ out_vals,
                 int32_t* __restrict__ out_idx,
                 int n_tiles, int k_local, int k_out) {
  const int lane = threadIdx.x;
  const size_t width = static_cast<size_t>(n_tiles) * k_local;
  const int* kv = reinterpret_cast<const int*>(vals) + blockIdx.x * width;
  const int32_t* gi = idx + blockIdx.x * width;
  float* ov = out_vals + static_cast<size_t>(blockIdx.x) * k_out;
  int32_t* oi = out_idx + static_cast<size_t>(blockIdx.x) * k_out;

  // head (hk, hg) and next (nk, ng) of each owned list; nxt = position of
  // the next entry in its list
  int hk[L], hg[L], nk[L], ng[L], nxt[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int list = lane * L + i;
    hk[i] = kNone;
    hg[i] = kIMax;
    nk[i] = kNone;
    ng[i] = kIMax;
    nxt[i] = 1;
    if (list < n_tiles) {
      const size_t at = static_cast<size_t>(list) * k_local;
      hk[i] = flip(__ldg(kv + at));
      hg[i] = __ldg(gi + at);
      if (k_local > 1) {
        nk[i] = flip(__ldg(kv + at + 1));
        ng[i] = __ldg(gi + at + 1);
      }
    }
  }
  // the lane's best head: highest key, lowest list (so lowest index) among
  // equal keys
  int bk = hk[0], bg = hg[0], bi = 0;
#pragma unroll
  for (int i = 1; i < L; ++i) {
    if (hk[i] > bk) {
      bk = hk[i];
      bg = hg[i];
      bi = i;
    }
  }
  // A round: the highest head key in the warp (one reduction), the lowest
  // lane holding it (one ballot: lower lanes own lower tiles, so that is
  // the lowest index at that key); that lane writes the pair and advances
  // the list.
  for (int round = 0; round < k_out; ++round) {
    const int top = __reduce_max_sync(kFull, bk);
    const unsigned holders = __ballot_sync(kFull, bk == top);
    if (lane == __ffs(holders) - 1) {
      ov[round] = value_of(top);
      oi[round] = bg;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i == bi) {
          hk[i] = nk[i];
          hg[i] = ng[i];
          const int p = ++nxt[i];
          if (p < k_local) {
            const size_t at = static_cast<size_t>(lane * L + i) * k_local + p;
            nk[i] = flip(__ldg(kv + at));
            ng[i] = __ldg(gi + at);
          } else {
            nk[i] = kNone;
            ng[i] = kIMax;
          }
        }
      }
      bk = hk[0];
      bg = hg[0];
      bi = 0;
#pragma unroll
      for (int i = 1; i < L; ++i) {
        if (hk[i] > bk) {
          bk = hk[i];
          bg = hg[i];
          bi = i;
        }
      }
    }
  }
}

// B2 for more than 32 * kMaxListsPerLane lists. Lane owns the contiguous
// lists [lane * per, lane * per + per), per = ceil(n_tiles / 32); each
// list's head key and position live in `heads`, shared memory or a row of
// the (b, n_tiles) workspace `work`. Only the winning lane touches memory
// in a round: it writes the pair, advances its list and rescans its heads.
__global__ void __launch_bounds__(32)
merge_tile_lists_wide(const float* __restrict__ vals,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out_vals,
                      int32_t* __restrict__ out_idx,
                      int2* __restrict__ work,
                      int n_tiles, int k_local, int k_out) {
  extern __shared__ int2 heads_s[];
  const int lane = threadIdx.x;
  const size_t width = static_cast<size_t>(n_tiles) * k_local;
  const int* kv = reinterpret_cast<const int*>(vals) + blockIdx.x * width;
  const int32_t* gi = idx + blockIdx.x * width;
  float* ov = out_vals + static_cast<size_t>(blockIdx.x) * k_out;
  int32_t* oi = out_idx + static_cast<size_t>(blockIdx.x) * k_out;
  int2* heads = work != nullptr
      ? work + static_cast<size_t>(blockIdx.x) * n_tiles : heads_s;
  const int per = (n_tiles + 31) / 32;
  const int lo = min(lane * per, n_tiles);
  const int hi = min(lo + per, n_tiles);

  // the lane's best head: highest key, lowest list among equal keys
  int bk = kNone, bl = lo;
  for (int list = lo; list < hi; ++list) {
    const int key = flip(__ldg(kv + static_cast<size_t>(list) * k_local));
    heads[list] = make_int2(key, 0);
    if (key > bk) {
      bk = key;
      bl = list;
    }
  }
  for (int round = 0; round < k_out; ++round) {
    const int top = __reduce_max_sync(kFull, bk);
    const unsigned holders = __ballot_sync(kFull, bk == top);
    if (lane == __ffs(holders) - 1) {
      const int p = heads[bl].y;
      const size_t at = static_cast<size_t>(bl) * k_local + p;
      ov[round] = value_of(top);
      oi[round] = __ldg(gi + at);
      heads[bl] = make_int2(p + 1 < k_local ? flip(__ldg(kv + at + 1)) : kNone,
                            p + 1);
      bk = kNone;
      bl = lo;
      for (int list = lo; list < hi; ++list) {
        const int key = heads[list].x;
        if (key > bk) {
          bk = key;
          bl = list;
        }
      }
    }
  }
}

template <int L>
cudaError_t launch_merge(const float* vals, const int32_t* idx,
                         float* out_vals, int32_t* out_idx, int b,
                         int n_tiles, int k_local, int k_out,
                         cudaStream_t stream) {
  merge_tile_lists<L><<<b, 32, 0, stream>>>(vals, idx, out_vals, out_idx,
                                             n_tiles, k_local, k_out);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Largest tile B1 holds in registers (32 lanes x 32 columns).
int pio_topk_fused_max_tile() { return 32 * kMaxPerLane; }

// Most candidate lists (tiles) a row may have before B2 needs a workspace
// of (b, n_tiles) int2 in global memory for the lists' heads.
int pio_topk_merge_shared_lists() {
  return kMergeSmemBytes / static_cast<int>(sizeof(int2));
}

// B1 on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Candidates land in out_vals / out_idx, (b, n_pad / tile * k_local) row
// major, tile-major within a row.
int pio_topk_fused_candidates(const void* u_q, const void* u_scale,
                              const void* vt_q, const void* v_scale,
                              const void* user_ixs, void* out_vals,
                              void* out_idx, int b, int r, int n_pad,
                              int tile, int k_local, int n_items,
                              void* stream) {
  if (b < 1 || r < 1 || tile < 1 || tile > 32 * kMaxPerLane
      || n_pad % tile != 0 || k_local < 1 || k_local > tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* uq = static_cast<const int8_t*>(u_q);
  const auto* us = static_cast<const float*>(u_scale);
  const auto* vq = static_cast<const int8_t*>(vt_q);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ix = static_cast<const int32_t*>(user_ixs);
  auto* ov = static_cast<float*>(out_vals);
  auto* oi = static_cast<int32_t*>(out_idx);
  auto st = static_cast<cudaStream_t>(stream);
  int p = 1;
  while (32 * p < tile) p *= 2;
  const bool vec = tile == 32 * p && p >= 4 && aligned16(vq) && aligned16(vs);
#define PIO_B1(P, V) \
  launch_candidates<P, V>(uq, us, vq, vs, ix, ov, oi, b, r, n_pad, tile, \
                          k_local, n_items, st)
  cudaError_t err;
  if (vec) {
    switch (p) {
      case 4: err = PIO_B1(4, true); break;
      case 8: err = PIO_B1(8, true); break;
      case 16: err = PIO_B1(16, true); break;
      default: err = PIO_B1(32, true); break;
    }
  } else {
    switch (p) {
      case 1: err = PIO_B1(1, false); break;
      case 2: err = PIO_B1(2, false); break;
      case 4: err = PIO_B1(4, false); break;
      case 8: err = PIO_B1(8, false); break;
      case 16: err = PIO_B1(16, false); break;
      default: err = PIO_B1(32, false); break;
    }
  }
#undef PIO_B1
  return static_cast<int>(err);
}

// B2 on `stream`: merges each row's n_tiles lists of k_local candidates
// (B1's output) into out_vals / out_idx, (b, k_out) row major, k_out <=
// n_tiles * k_local. `work` holds b * n_tiles int2 when n_tiles exceeds
// pio_topk_merge_shared_lists(), and is not read otherwise. Returns
// cudaGetLastError() after the launch.
int pio_topk_merge(const void* vals, const void* idx, void* out_vals,
                   void* out_idx, void* work, int b, int n_tiles,
                   int k_local, int k_out, void* stream) {
  const int shared_lists = pio_topk_merge_shared_lists();
  if (b < 1 || n_tiles < 1 || k_local < 1 || k_out < 1
      || static_cast<long long>(k_out)
          > static_cast<long long>(n_tiles) * k_local
      || (n_tiles > shared_lists && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const float*>(vals);
  const auto* g = static_cast<const int32_t*>(idx);
  auto* ov = static_cast<float*>(out_vals);
  auto* oi = static_cast<int32_t*>(out_idx);
  auto st = static_cast<cudaStream_t>(stream);
  const int lists = (n_tiles + 31) / 32;
  if (lists > kMaxListsPerLane) {
    const bool in_smem = n_tiles <= shared_lists;
    merge_tile_lists_wide<<<b, 32, in_smem ? n_tiles * sizeof(int2) : 0,
                            st>>>(
        v, g, ov, oi, in_smem ? nullptr : static_cast<int2*>(work), n_tiles,
        k_local, k_out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (lists <= 1) err = launch_merge<1>(v, g, ov, oi, b, n_tiles, k_local, k_out, st);
  else if (lists <= 2) err = launch_merge<2>(v, g, ov, oi, b, n_tiles, k_local, k_out, st);
  else if (lists <= 4) err = launch_merge<4>(v, g, ov, oi, b, n_tiles, k_local, k_out, st);
  else if (lists <= 8) err = launch_merge<8>(v, g, ov, oi, b, n_tiles, k_local, k_out, st);
  else if (lists <= 16) err = launch_merge<16>(v, g, ov, oi, b, n_tiles, k_local, k_out, st);
  else err = launch_merge<32>(v, g, ov, oi, b, n_tiles, k_local, k_out, st);
  return static_cast<int>(err);
}

}  // extern "C"
