// +INT bulk join: out[i, j] = a[i, j] in b[i, :]; a negative a never matches.
//
// Replaces the TPU kernel repro/kernels/sorted_intersect.py
// tile_membership_pallas, which evaluated the TA x TB equality cube on the
// VPU per row tile.  The executor calls it with TA = 1 and TB = pow2(max
// degree) in [8, 128], on tens of thousands of rows: a call moves a few
// megabytes at most, so what bounds it on this card is latency (the launch,
// then one or a few dependent memory round trips), not bytes.
//
// Design:
//   * A group of G lanes covers one row, G the power of two that gives each
//     lane at most 4 of the TB words (G = TB / 4 for the engine's TB), so a
//     warp serves 32 / G rows and a block of 8 warps 256 / G rows.  In the
//     contract form with TB = 4G and a 16-byte-aligned b, each lane reads
//     its 4 words as one 16-byte load (one load for the whole row per
//     group); otherwise lane k reads words k, k + G, ... as 4-byte loads.
//   * One ballot per warp and per j: each group's bits, masked out of the
//     ballot, answer its row.
//   * The block's results are staged as bytes in shared memory and written
//     as 32-bit words: no lone byte store per row.
//   * The range form builds its own tile: row i clamps probe[i] into
//     [0, n-1], reads lo = iptr[p] and hi = iptr[p + 1], and tests
//     v[i] against nbr[clamp(pos, 0, m-1)] for pos in [lo, min(hi, lo + TB)):
//     the executor's adj_tile (its -2 fill never matches a v >= 0), with no
//     [rows, TB] tile written and read back, and no torch gathers before
//     it.  lo has no alignment, so its lanes read 4-byte words at lo + k,
//     lo + k + G, ...: coalesced within the group, and, since TB is the
//     power of two above the label's largest degree, most rows' ranges are
//     shorter than TB, and the loads past hi are predicated off, so only
//     the sectors the range touches are fetched (a window of aligned
//     16-byte loads would fetch past hi and need a fifth load for the
//     misaligned end).  A row whose v is negative reads nothing.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageBytes = 8192;  // a block's results staged in shared

enum Mode { kVec = 0, kScalar = 1, kRange = 2 };

struct Args {
  const int32_t* a;      // contract: [rows, ta]; range: v [rows]
  const int32_t* b;      // contract: [rows, tb]; range: nbr [m]
  const int32_t* iptr;   // range: [n + 1]
  const int32_t* probe;  // range: probe[i * pstride]
  long long pstride;
  int m;
  int n;
  int rows;
  int ta;
  int tb;
  bool* out;
};

// G lanes a row: the smallest power of two that leaves a lane at most 4 of
// the tb words, at most 32.
inline int lanes_for(int tb) {
  int g = 1;
  while (g < 32 && 4 * g < tb) g <<= 1;
  return g;
}

template <int G, int kMode>
__global__ void __launch_bounds__(kThreads) tile_membership_kernel(Args a) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
  constexpr unsigned kGroupMask = G == 32 ? kFull : ((1u << G) - 1u);
  __shared__ uint32_t s_words[kStageBytes / 4];
  unsigned char* s_bytes = reinterpret_cast<unsigned char*>(s_words);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane / G;
  const int k = lane % G;
  const long long block_row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long row = block_row0 + warp * kRowsPerWarp + group;
  const bool live = row < a.rows;
  const int ta = kMode == kRange ? 1 : a.ta;
  const bool staged = kRowsPerBlock * ta <= kStageBytes;

  // the row's words: 4 in registers (vector form), or read per j
  int4 mine = make_int4(-1, -1, -1, -1);
  int lo = 0;
  long long end = 0;  // range form: the row's words are nbr[lo, end)
  const int32_t* brow =
      a.b + (live && kMode != kRange ? row : 0) * static_cast<long long>(a.tb);
  if (live) {
    if constexpr (kMode == kVec) {
      mine = __ldg(reinterpret_cast<const int4*>(brow) + k);
    } else if constexpr (kMode == kRange) {
      const int p = repro::clampi(__ldg(a.probe + row * a.pstride), 0,
                                  a.n - 1);
      lo = __ldg(a.iptr + p);
      const int hi = __ldg(a.iptr + p + 1);
      end = min(static_cast<long long>(hi),
                static_cast<long long>(lo) + a.tb);
    }
  }

  for (int j = 0; j < ta; ++j) {
    const int32_t x = live ? __ldg(a.a + row * ta + j) : -1;
    bool hit = false;
    if (x >= 0) {
      if constexpr (kMode == kVec) {
        hit = mine.x == x || mine.y == x || mine.z == x || mine.w == x;
      } else if constexpr (kMode == kScalar) {
        // 4 words of the row in flight a lane: c, c + G, c + 2G, c + 3G
        for (int c0 = k; c0 < a.tb; c0 += 4 * G) {
          int w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = c0 + u * G;
            w[u] = c < a.tb ? __ldg(brow + c) : -1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) hit |= w[u] == x;
        }
      } else {
        for (long long p0 = lo + k; p0 < end; p0 += 4 * G) {
          int w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const long long pos = p0 + u * G;
            const long long idx = min(max(pos, 0ll),
                                      static_cast<long long>(a.m - 1));
            w[u] = pos < end ? __ldg(a.b + idx) : -1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) hit |= w[u] == x;
        }
      }
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane < kRowsPerWarp) {
      const long long r = block_row0 + warp * kRowsPerWarp + lane;
      const unsigned char res = ((ballot >> (lane * G)) & kGroupMask) != 0u;
      if (r < a.rows) {
        if (staged) {
          s_bytes[(warp * kRowsPerWarp + lane) * ta + j] = res;
        } else {
          a.out[r * ta + j] = res;
        }
      }
    }
  }
  if (!staged) return;  // uniform over the block
  __syncthreads();
  // the block's rows are out[block_row0 * ta, ...): 4-byte aligned, since
  // kRowsPerBlock is a multiple of 8 and out is a fresh allocation
  const long long left = a.rows - block_row0;
  const int n_bytes =
      static_cast<int>(left < kRowsPerBlock ? left : kRowsPerBlock) * ta;
  unsigned char* dst = reinterpret_cast<unsigned char*>(a.out) + block_row0 * ta;
  for (int w = threadIdx.x; w < n_bytes / 4; w += kThreads) {
    reinterpret_cast<uint32_t*>(dst)[w] = s_words[w];
  }
  for (int c = (n_bytes & ~3) + threadIdx.x; c < n_bytes; c += kThreads) {
    dst[c] = s_bytes[c];
  }
}

template <int G>
cudaError_t launch_g(const Args& a, int mode, cudaStream_t st) {
  const unsigned blocks = repro::blocks_for(a.rows, kWarps * (32 / G));
  if (mode == kVec) {
    tile_membership_kernel<G, kVec><<<blocks, kThreads, 0, st>>>(a);
  } else if (mode == kScalar) {
    tile_membership_kernel<G, kScalar><<<blocks, kThreads, 0, st>>>(a);
  } else {
    tile_membership_kernel<G, kRange><<<blocks, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int mode, cudaStream_t st) {
  switch (lanes_for(a.tb)) {
    case 1: return launch_g<1>(a, mode, st);
    case 2: return launch_g<2>(a, mode, st);
    case 4: return launch_g<4>(a, mode, st);
    case 8: return launch_g<8>(a, mode, st);
    case 16: return launch_g<16>(a, mode, st);
    default: return launch_g<32>(a, mode, st);
  }
}

}  // namespace

// The contract form: a int32 [rows, ta], b int32 [rows, tb], out bool
// [rows, ta] (a fresh allocation).
REPRO_EXPORT int repro_tile_membership(const void* a, const void* b,
                                       void* out, int rows, int ta, int tb,
                                       void* stream) {
  if (rows <= 0 || ta <= 0 || tb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
            nullptr, nullptr, 0, 0, 0, rows, ta, tb,
            static_cast<bool*>(out)};
  // a row as one 16-byte load per lane: tb = 4G words and b 16-byte aligned
  // (then every row is, tb being a multiple of 4)
  const bool vec = tb > 0 && tb == 4 * lanes_for(tb) &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return static_cast<int>(
      launch(args, vec ? kVec : kScalar, static_cast<cudaStream_t>(stream)));
}

// The range form: out[i] = v[i] >= 0 and v[i] in nbr[clamp(pos, 0, m-1)]
// for pos in [lo, min(hi, lo + tb)), lo = iptr[p], hi = iptr[p + 1],
// p = clamp(probe[i * pstride], 0, n - 1).  nbr int32 [m >= 1], iptr int32
// [n + 1], v int32 [rows], out bool [rows] (a fresh allocation).
REPRO_EXPORT int repro_tile_membership_range(
    const void* nbr, int m, const void* iptr, int n, const void* probe,
    long long pstride, const void* v, int rows, int tb, void* out,
    void* stream) {
  if (rows <= 0 || m <= 0 || n <= 0 || tb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{static_cast<const int32_t*>(v), static_cast<const int32_t*>(nbr),
            static_cast<const int32_t*>(iptr),
            static_cast<const int32_t*>(probe), pstride, m, n, rows, 1, tb,
            static_cast<bool*>(out)};
  return static_cast<int>(
      launch(args, kRange, static_cast<cudaStream_t>(stream)));
}
