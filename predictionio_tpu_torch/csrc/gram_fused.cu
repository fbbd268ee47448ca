// Kernel G: the ALS Gram and right-hand side of every row of one side, in
// one pass, written by hand for Hopper (sm_90a). Built by
// predictionio_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface, bound with ctypes by
// predictionio_tpu_torch/ops/gram_fused.py.
//
// Replaces no TPU kernel: the JAX package leaves its Gram to XLA
// (predictionio_tpu/ops/als.py::gram_rhs and its csrb / hybrid layouts).
// It replaces the port's chunked plain Gram (ops/als.py::gram_rhs_plain:
// a gather, a cat, a (chunk, r^2 + r) outer product written to device
// memory, two levels of segment_reduce and an index_copy_ per chunk of
// 262,144 entries). For each row s of the side it computes
//   A_s = sum_n a_n v_n v_n^T,   b_s = sum_n b_n v_n
// over the row's entries n, v_n the other side's factor row other_idx[n].
//
// What bounds it on the H100 (pio_bench/roofline/gram.py counts the same):
// r (r + 1) / 2 + r fused multiply-adds a rating (the upper triangle and b)
// against 12 bytes of the rating, the other side's factors once and A and b
// written once per row. At ML-20M (r = 20) the user side is narrowly bound
// by bytes, the item side by operations; at Netflix (r = 32) both sides by
// operations. Beyond the roofline's bytes, every entry gathers its factor
// row (4 r bytes), mostly from L2 (the factors are 2-61 MB). The kernel
// runs at about 4-5 times the bound (PERF.md). Its stall reasons are not
// measured; the variants below that put more of the gather in flight did
// not help, so it is not its latency that holds the kernel back.
//
// The design:
//   * Work units are pieces: a row's run of entries cut at 512 entries
//     (ops/gram_fused.py::PIECE), from a plan built once per layout
//     (ops/gram_fused.py::plan). The plan lists the pieces with a schedule
//     that starts with the longest rows, so a Zipf head spread over many
//     pieces runs first and leaves no tail. A row with no entry is one
//     empty piece, so every row of A and b is written.
//   * One warp takes one piece; a block holds kWarps of them. The warp
//     stages kBatch entries at a time: their indices and weights into
//     registers one batch ahead, then their factor rows into shared memory
//     with cp.async, in a ring of kStages buffers, so the next batch's
//     gather is in flight while this batch is summed. (Measured on the
//     H100: three or four buffers, two entries a lane, a deeper register
//     prefetch, persistent warps that run many pieces as one stream, or a
//     register cap for more resident warps were all slower or no faster.)
//   * Register tiling: the upper triangle of the (r, r) product is cut
//     into T x T tiles (T = 4 up to r = 20, else 8). A lane owns one tile
//     (a unit) and one of KS groups of entries (the lanes of a group share
//     an entry, so its loads are broadcasts); per entry it scales its T
//     rows by a_n and does T^2 fused multiply-adds into registers, two
//     entries a turn. The lanes owning a diagonal tile also sum b over the
//     tile's columns. fp32 on the CUDA cores only: no tensor core, no TF32.
//   * Above r = 32 the product is cut into 32 x 32 block tiles of A's
//     upper triangle, one per grid row (blockIdx.y); each stages the two
//     32-column segments of the factor rows it needs. No rank falls back
//     to the plain Gram.
//   * The KS groups' tiles are summed in shared memory in group order, and
//     the warp writes the row coalesced, the lower triangle read from the
//     upper (A comes out exactly symmetric): a row of one piece straight
//     into the contiguous (n_self, r, r) and (n_self, r) outputs, the
//     piece of a longer row into its slot of a scratch buffer.
//     gram_finish then sums each such row's slots in piece order.
//
// Determinism: every sum runs in an order fixed by the plan (entries of a
// group in order, groups in order, pieces in order); no atomics. Two runs
// give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;      // warps of a block, one piece each
constexpr int kBatch = 32;     // entries staged per step, one per lane
constexpr int kStages = 2;     // staged batches in flight, a ring
constexpr int kUnroll = 2;     // entries summed per turn of the inner loop
constexpr int kSeg = 32;       // width of a block tile of A above rank 32

// The register tiling of a segment of W columns.
template <int W>
struct Tiling {
  static constexpr int T = W <= 20 ? 4 : 8;           // tile edge
  static constexpr int NT = (W + T - 1) / T;           // tiles per edge
  static constexpr int WP = NT * T;                    // padded width
  // shared row stride in floats: an odd number of 16-byte words, so the
  // rows of neighbouring entries start in different banks
  static constexpr int S = (WP / 4) % 2 ? WP : WP + 4;
  static constexpr int UNITS_DIAG = NT * (NT + 1) / 2;  // upper tiles
  static constexpr int UNITS_OFF = NT * NT;             // all tiles
  static constexpr int KS_DIAG = 32 / UNITS_DIAG;      // entry groups
  static constexpr int KS_OFF = 32 / UNITS_OFF;
  static_assert(UNITS_OFF <= 32, "a warp covers one block tile");
};

struct Args {
  const float* V;        // (n_other, r) the other side's factors
  const void* idx;       // (nnz,) other_idx, int32 or int64
  int idx64;
  const float* ca;       // (nnz,) Gram weight a_n
  const float* cb;       // (nnz,) right-hand-side weight b_n
  float* A;              // (n_self, r, r)
  float* b;              // (n_self, r)
  float* parts;          // (n_parts, r * r + r): pieces of longer rows
  int r;
  int cp_bytes;          // 16, 8 or 4: the widest copy rows and V allow
};

struct Plan {
  const int* schedule;          // piece ids in launch order
  const int* piece_row;         // -1: an unused slot
  const long long* piece_start; // first entry
  const int* piece_len;         // entries, at most 512
  const int* piece_part;        // scratch slot, -1: the row is one piece
  int n_pieces;
};

template <int CB>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(CB) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy columns [col0, col0 + width) of the factor rows of the nb staged
// entries into dst (row stride S floats), in CB-byte pieces.
template <int CB, int S>
__device__ __forceinline__ void gather_rows(float* dst, const int* sidx,
                                            int nb, const float* V, int r,
                                            int col0, int width, int lane) {
  constexpr int step = CB / 4;
  const int per_row = width / step;
  for (int c = lane; c < nb * per_row; c += 32) {
    const int e = c / per_row, q = c - e * per_row;
    cp_async<CB>(dst + e * S + q * step,
                 V + static_cast<size_t>(sidx[e]) * r + col0 + q * step);
  }
}

template <int S>
__device__ __forceinline__ void gather(int cp_bytes, float* dst,
                                       const int* sidx, int nb,
                                       const float* V, int r, int col0,
                                       int width, int lane) {
  if (cp_bytes == 16) {
    gather_rows<16, S>(dst, sidx, nb, V, r, col0, width, lane);
  } else if (cp_bytes == 8) {
    gather_rows<8, S>(dst, sidx, nb, V, r, col0, width, lane);
  } else {
    gather_rows<4, S>(dst, sidx, nb, V, r, col0, width, lane);
  }
}

// Entry `lane` of batch k of a piece: its other-side row and two weights
// (zeros past the piece's end).
__device__ __forceinline__ void load_entry(const Args& a, long long e0,
                                           int n, int k, int lane, int& idx,
                                           float& wa, float& wb) {
  const int e = k * kBatch + lane;
  idx = 0;
  wa = 0.f;
  wb = 0.f;
  if (e < n) {
    const long long at = e0 + e;
    idx = a.idx64 ? static_cast<int>(
                        __ldg(static_cast<const long long*>(a.idx) + at))
                  : __ldg(static_cast<const int*>(a.idx) + at);
    wa = __ldg(a.ca + at);
    wb = __ldg(a.cb + at);
  }
}

// Shared memory of one warp, in floats: two staging buffers of kBatch
// factor rows (two segments of them above rank 32), the (a, b) of each
// buffer's entries and the indices being gathered. A piece's sums (M: WP
// x WP with row stride MS, then b) reuse the staging buffers at its end.
template <int W, bool WIDE>
struct Smem {
  using L = Tiling<W>;
  static constexpr int SEGS = WIDE ? 2 : 1;
  static constexpr int STAGE = kBatch * L::S;           // one segment
  static constexpr int MS = L::WP + 1;   // odd: a column reads no bank twice
  static constexpr int kFloats =
      kStages * SEGS * STAGE + kStages * kBatch * 2 + kBatch;
  static_assert(L::WP * MS + L::WP <= kStages * SEGS * STAGE, "M fits");
  static_assert(kFloats % 4 == 0, "16-byte aligned per warp");
};

// One piece per warp. Up to rank 32, W is the rank and blockIdx.y is 0;
// above it (WIDE), W is kSeg and blockIdx.y picks the block tile (bi, bj),
// bi <= bj, of A.
template <int W, bool WIDE>
__global__ void __launch_bounds__(kWarps * 32)
gram_pieces(Args a, Plan p) {
  using L = Tiling<W>;
  using SM = Smem<W, WIDE>;
  constexpr int T = L::T, NT = L::NT, WP = L::WP, S = L::S;
  constexpr int STAGE = SM::STAGE, SEGS = SM::SEGS, MS = SM::MS;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kWarps + warp;
  if (slot >= p.n_pieces) return;
  const int piece = p.schedule[slot];
  const int row = p.piece_row[piece];
  if (row < 0) return;
  const long long e0 = p.piece_start[piece];
  const int n = p.piece_len[piece];
  const int part = p.piece_part[piece];

  const int r = WIDE ? a.r : W;
  int bi = 0, bj = 0;
  if (WIDE) {
    const int nseg = (r + kSeg - 1) / kSeg;
    int t = blockIdx.y;
    while (t >= nseg - bi) {
      t -= nseg - bi;
      ++bi;
    }
    bj = bi + t;
  }
  const bool diag = bi == bj;
  const int ci = bi * kSeg, cj = bj * kSeg;
  const int wi = WIDE ? min(W, r - ci) : W;
  const int wj = WIDE ? min(W, r - cj) : W;

  float* base = smem + warp * SM::kFloats;
  float* stage = base;                            // [kStages][SEGS][STAGE]
  float2* sab = reinterpret_cast<float2*>(base + kStages * SEGS * STAGE);
  int* sidx = reinterpret_cast<int*>(sab + kStages * kBatch);

  // this lane's tile (ti, tj) and entry group g
  const int units = diag ? L::UNITS_DIAG : L::UNITS_OFF;
  const int ks = diag ? L::KS_DIAG : L::KS_OFF;
  const bool active = lane < units * ks;
  const int u = lane % units, g = lane / units;
  int ti, tj;
  if (diag) {
    int t = u;
    ti = 0;
    while (t >= NT - ti) {
      t -= NT - ti;
      ++ti;
    }
    tj = ti + t;
  } else {
    ti = u / NT;
    tj = u % NT;
  }
  const bool b_unit = diag && ti == tj;

  float acc[T][T];
  float accb[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    accb[i] = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = 0.f;
  }

  // stage batch k into buffer buf from this lane's registers
  auto stage_batch = [&](int k, int buf, int idx, float wa, float wb) {
    sidx[lane] = idx;
    sab[buf * kBatch + lane] = make_float2(wa, wb);
    __syncwarp();
    const int cnt = min(kBatch, n - k * kBatch);
    float* dst = stage + buf * SEGS * STAGE;
    gather<S>(a.cp_bytes, dst, sidx, cnt, a.V, r, ci, wi, lane);
    if (!diag) {
      gather<S>(a.cp_bytes, dst + STAGE, sidx, cnt, a.V, r, cj, wj, lane);
    }
  };

  // batches 0 .. kStages - 2 in flight, the next one's entries loaded
  const int nbatch = (n + kBatch - 1) / kBatch;
  int idx;              // the next batch's entry of this lane
  float wa, wb;
  load_entry(a, e0, n, 0, lane, idx, wa, wb);
#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) {
    if (k < nbatch) {
      if (k) __syncwarp();                // the last gather read sidx
      stage_batch(k, k, idx, wa, wb);
      load_entry(a, e0, n, k + 1, lane, idx, wa, wb);
    }
    cp_commit();
  }

  for (int k = 0; k < nbatch; ++k) {
    const int buf = k % kStages;
    const int kn = k + kStages - 1;       // the batch staged now
    if (kn < nbatch) {
      __syncwarp();                       // the last gather read sidx
      stage_batch(kn, kn % kStages, idx, wa, wb);
      load_entry(a, e0, n, kn + 1, lane, idx, wa, wb);
    }
    cp_commit();
    cp_wait<kStages - 1>();               // this lane's copies of batch k
    __syncwarp();                         // and every lane's
    const int cnt = min(kBatch, n - k * kBatch);
    const float* yv = stage + buf * SEGS * STAGE;
    const float* xv = diag ? yv : yv + STAGE;
    const float2* ab = sab + buf * kBatch;
    if (active) {
#pragma unroll kUnroll
      for (int e = g; e < cnt; e += ks) {
        const float2 cw = ab[e];
        float y[T], x[T];
        const float4* yp = reinterpret_cast<const float4*>(yv + e * S + ti * T);
        const float4* xp = reinterpret_cast<const float4*>(xv + e * S + tj * T);
#pragma unroll
        for (int q = 0; q < T / 4; ++q) {
          const float4 y4 = yp[q], x4 = xp[q];
          y[4 * q] = y4.x;
          y[4 * q + 1] = y4.y;
          y[4 * q + 2] = y4.z;
          y[4 * q + 3] = y4.w;
          x[4 * q] = x4.x;
          x[4 * q + 1] = x4.y;
          x[4 * q + 2] = x4.z;
          x[4 * q + 3] = x4.w;
        }
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const float w = cw.x * y[i];
#pragma unroll
          for (int j = 0; j < T; ++j) acc[i][j] = __fmaf_rn(w, x[j], acc[i][j]);
        }
        if (b_unit) {
#pragma unroll
          for (int j = 0; j < T; ++j) accb[j] = __fmaf_rn(cw.y, x[j], accb[j]);
        }
      }
    }
    __syncwarp();                         // buf is free for a later batch
  }

  // sum the groups' tiles in group order into M, over the staging
  // buffers: every copy has landed and been read
  float* M = base;
  for (int gg = 0; gg < ks; ++gg) {
    if (active && g == gg) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const int gi = ti * T + i, gj = tj * T + j;
          if (!diag || gi <= gj) {
            float* m = M + gi * MS + gj;
            *m = gg ? *m + acc[i][j] : acc[i][j];
          }
        }
      }
      if (b_unit) {
#pragma unroll
        for (int j = 0; j < T; ++j) {
          float* m = M + WP * MS + tj * T + j;
          *m = gg ? *m + accb[j] : accb[j];
        }
      }
    }
    __syncwarp();
  }

  // the row, coalesced; A's lower triangle is its upper mirrored
  const size_t rr = static_cast<size_t>(r) * r;
  float* out_a = part >= 0 ? a.parts + static_cast<size_t>(part) * (rr + r)
                           : a.A + static_cast<size_t>(row) * rr;
  float* out_b = part >= 0 ? out_a + rr : a.b + static_cast<size_t>(row) * r;
  for (int k = lane; k < wi * wj; k += 32) {
    const int i = k / wj, j = k - i * wj;
    const float v = !diag || i <= j ? M[i * MS + j] : M[j * MS + i];
    out_a[static_cast<size_t>(ci + i) * r + cj + j] = v;
    if (!diag) out_a[static_cast<size_t>(cj + j) * r + ci + i] = v;
  }
  if (diag) {
    for (int j = lane; j < wj; j += 32) out_b[cj + j] = M[WP * MS + j];
  }
}

// The rows of several pieces: each slot of a row's run in piece order,
// summed in that order, into A and b.
__global__ void __launch_bounds__(256)
gram_finish(const float* __restrict__ parts, const int* __restrict__ mrow,
            const int* __restrict__ mfirst, const int* __restrict__ mcount,
            float* __restrict__ A, float* __restrict__ b, int r) {
  const int m = blockIdx.x;
  const int row = mrow[m], cnt = mcount[m];
  if (row < 0 || cnt < 2) return;
  const int rr = r * r, len = rr + r;
  const float* src = parts + static_cast<size_t>(mfirst[m]) * len;
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const float* s = src + k;
    float acc = s[0];
    int q = 1;
    for (; q + 8 <= cnt; q += 8) {        // eight loads in flight, added in order
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = s[static_cast<size_t>(q + t) * len];
#pragma unroll
      for (int t = 0; t < 8; ++t) acc = __fadd_rn(acc, v[t]);
    }
    for (; q < cnt; ++q) acc = __fadd_rn(acc, s[static_cast<size_t>(q) * len]);
    if (k < rr) {
      A[static_cast<size_t>(row) * rr + k] = acc;
    } else {
      b[static_cast<size_t>(row) * r + (k - rr)] = acc;
    }
  }
}

template <int W, bool WIDE>
int launch(const Args& a, const Plan& p, cudaStream_t st) {
  constexpr int smem = sizeof(float) * Smem<W, WIDE>::kFloats * kWarps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_pieces<W, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nseg = WIDE ? (a.r + kSeg - 1) / kSeg : 1;
  const dim3 grid((p.n_pieces + kWarps - 1) / kWarps, nseg * (nseg + 1) / 2);
  gram_pieces<W, WIDE><<<grid, kWarps * 32, smem, st>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest rank with an instance of its own; above it, 32 x 32 block tiles.
int pio_gram_max_tiled_rank() { return kSeg; }

// The pieces of one Gram on `stream`: V (n_other, r), idx / ca / cb (nnz,),
// A (n_self, r, r), b (n_self, r), parts (n_parts, r * r + r), the plan's
// five arrays of n_pieces; float32 / int32 / int64 as above, contiguous.
// Returns cudaGetLastError() after the launch (0 = ok).
int pio_gram_pieces(const void* V, const void* idx, int idx64,
                    const void* ca, const void* cb, void* A, void* b,
                    void* parts, int r, int cp_bytes, const void* schedule,
                    const void* piece_row, const void* piece_start,
                    const void* piece_len, const void* piece_part,
                    int n_pieces, void* stream) {
  if (n_pieces <= 0) return 0;
  if (r <= 0 || (cp_bytes != 16 && cp_bytes != 8 && cp_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(V), idx, idx64,
               static_cast<const float*>(ca), static_cast<const float*>(cb),
               static_cast<float*>(A), static_cast<float*>(b),
               static_cast<float*>(parts), r, cp_bytes};
  const Plan p{static_cast<const int*>(schedule),
               static_cast<const int*>(piece_row),
               static_cast<const long long*>(piece_start),
               static_cast<const int*>(piece_len),
               static_cast<const int*>(piece_part), n_pieces};
  auto st = static_cast<cudaStream_t>(stream);
  switch (r) {
#define PIO_GRAM_RANK(R) \
    case R: return launch<R, false>(a, p, st);
    PIO_GRAM_RANK(1) PIO_GRAM_RANK(2) PIO_GRAM_RANK(3) PIO_GRAM_RANK(4)
    PIO_GRAM_RANK(5) PIO_GRAM_RANK(6) PIO_GRAM_RANK(7) PIO_GRAM_RANK(8)
    PIO_GRAM_RANK(9) PIO_GRAM_RANK(10) PIO_GRAM_RANK(11) PIO_GRAM_RANK(12)
    PIO_GRAM_RANK(13) PIO_GRAM_RANK(14) PIO_GRAM_RANK(15) PIO_GRAM_RANK(16)
    PIO_GRAM_RANK(17) PIO_GRAM_RANK(18) PIO_GRAM_RANK(19) PIO_GRAM_RANK(20)
    PIO_GRAM_RANK(21) PIO_GRAM_RANK(22) PIO_GRAM_RANK(23) PIO_GRAM_RANK(24)
    PIO_GRAM_RANK(25) PIO_GRAM_RANK(26) PIO_GRAM_RANK(27) PIO_GRAM_RANK(28)
    PIO_GRAM_RANK(29) PIO_GRAM_RANK(30) PIO_GRAM_RANK(31) PIO_GRAM_RANK(32)
#undef PIO_GRAM_RANK
    default:
      return launch<kSeg, true>(a, p, st);
  }
}

// Sum the scratch slots of the n_multi rows of several pieces into A and b
// on `stream`: row mrow[m] (-1: none) from slots mfirst[m] ..
// mfirst[m] + mcount[m] - 1, in that order. Returns cudaGetLastError().
int pio_gram_finish(const void* parts, const void* mrow, const void* mfirst,
                    const void* mcount, int n_multi, void* A, void* b, int r,
                    void* stream) {
  if (n_multi <= 0) return 0;
  gram_finish<<<n_multi, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(parts), static_cast<const int*>(mrow),
      static_cast<const int*>(mfirst), static_cast<const int*>(mcount),
      static_cast<float*>(A), static_cast<float*>(b), r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
