// Banded Smith-Waterman-Gotoh alignment (fill + traceback) for NVIDIA Hopper,
// called from JAX through the XLA FFI (kaptive_tpu/ops/swg_cuda.py).
//
// The result is bit-identical to kaptive_tpu.ops.swg.banded_swg_lax in all
// eight SwgResult fields: same band geometry in diagonal coordinates, same
// masks, local reset, tie rules and traceback state machine.  Only the
// schedule differs:
//
// - One warp per pair.  The w-cell band is split into 32 contiguous runs of
//   C = w / 32 cells, one per lane; the M and D bands live in registers.
// - The row loop runs inside the kernel.  The pair's query and target bytes
//   are staged once in shared memory, the target also as substitution-column
//   classes; the exact class factorisation of the 256x256 matrix
//   (kaptive_tpu.ops.swg.compress_matrix) sits in shared memory.
// - Horizontal gaps use the lazy-F max-plus scan of the lax path: a
//   sequential prefix max over each lane's run plus a 5-step warp-shuffle
//   scan of the run totals.
// - Traceback bits (4 per cell) are written coalesced, one half-byte per
//   cell, to a scratch result; lane 0 then walks them in the same kernel.
//
// Build: see kaptive_tpu/ops/swg_cuda.py (nvcc -gencode
// arch=compute_90a,code=sm_90a, keyed on this file's hash).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kNeg = -1000000000;
constexpr int kWarps = 2;       // pairs per block
constexpr int kClassStride = 32;  // column classes per substitution-table row
constexpr int kMaxRowClasses = 64;

struct Outs {
  int32_t* f[8];  // scores, matches, mismatches, gaps, q_starts, q_ends, t_starts, t_ends
};

__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

template <int C>
__global__ void __launch_bounds__(32 * kWarps)
swg_kernel(const uint8_t* __restrict__ q_codes, const int32_t* __restrict__ q_lens,
           const uint8_t* __restrict__ t_codes, const int32_t* __restrict__ t_lens,
           const int32_t* __restrict__ offsets, const int32_t* __restrict__ k_locals,
           const int32_t* __restrict__ row_lut, const int32_t* __restrict__ col_lut,
           const int32_t* __restrict__ small, int n_row, int n_col, int B, int R,
           int q_stride, int T, int32_t gap_open, int32_t gap_extend, Outs outs,
           uint8_t* __restrict__ tb) {
  constexpr int W = 32 * C;
  constexpr int HALF = W / 2;  // traceback bytes per row
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sub = reinterpret_cast<int32_t*>(smem);
  uint8_t* rlut = smem + n_row * kClassStride * 4;
  uint8_t* clut = rlut + 256;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_warp = round16(R) + 2 * round16(T);
  uint8_t* qs = clut + 256 + warp * per_warp;
  uint8_t* traw = qs + round16(R);
  uint8_t* tcls = traw + round16(T);

  for (int x = threadIdx.x; x < n_row * kClassStride; x += blockDim.x) {
    const int r = x / kClassStride, c = x % kClassStride;
    sub[x] = c < n_col ? small[r * n_col + c] : 0;
  }
  for (int x = threadIdx.x; x < 256; x += blockDim.x) {
    rlut[x] = static_cast<uint8_t>(row_lut[x]);
    clut[x] = static_cast<uint8_t>(col_lut[x]);
  }
  __syncthreads();

  const int p = blockIdx.x * kWarps + warp;
  if (p >= B) return;

  const uint8_t* qg = q_codes + static_cast<size_t>(p) * q_stride;
  const uint8_t* tg = t_codes + static_cast<size_t>(p) * T;
  for (int x = lane; x < R; x += 32) qs[x] = qg[x];
  for (int x = lane; x < T; x += 32) {
    const uint8_t v = tg[x];
    traw[x] = v;
    tcls[x] = clut[v];
  }
  __syncwarp();

  const int32_t len1 = q_lens[p];
  const int32_t len2 = t_lens[p];
  const int32_t off = offsets[p];
  const int32_t kl = k_locals[p];
  const int32_t ge = gap_extend;
  const int32_t go = gap_open;
  const int32_t goe = go + ge;
  const int32_t k_pad = (W - 3) / 2;
  const int32_t pad = W + 2;
  const int32_t cols = len2 + 1;
  const int32_t center = k_pad + 1;
  const int dm0 = lane * C;
  const unsigned full = 0xffffffffu;

  int32_t m[C], d[C], diag[C], hc[C], ex[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int32_t dm = dm0 + c;
    const int32_t j0 = -off + dm - k_pad - 1;
    const int32_t band = dm > center ? dm - center : center - dm;
    m[c] = (band <= kl + 1 && j0 >= 0 && j0 < cols) ? 0 : kNeg;
    d[c] = kNeg;
  }

  // Lane-local running best: the first (row, dm) in scan order with the
  // lane's largest M; the warp reduction below picks the smallest (row, dm)
  // among the lanes holding the overall maximum, which is exactly the lax
  // path's strictly-greater, first-cell-wins row-by-row update.
  int32_t tbest = 0, tbi = 0, tbdm = 0;
  uint8_t* tb_pair = tb + static_cast<size_t>(p) * R * HALF;

  for (int32_t i = 1; i <= R; ++i) {
    const bool active = i <= len1;
    int32_t mn = __shfl_down_sync(full, m[0], 1);
    int32_t dn = __shfl_down_sync(full, d[0], 1);
    if (lane == 31) {
      mn = kNeg;
      dn = kNeg;
    }
    const int32_t* srow = sub + rlut[qs[i - 1]] * kClassStride;
    int32_t base = i - off - k_pad - 2 + pad;  // lax dynamic_slice start, clamped
    base = base < 0 ? 0 : (base > T - W ? T - W : base);
    const int32_t jb = i - off - k_pad - 1;

    uint64_t fmask = 0, pmask = 0, dbits = 0;
    int32_t run = kNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int32_t dm = dm0 + c;
      const int32_t j = jb + dm;
      const int32_t band = dm > center ? dm - center : center - dm;
      const bool filled = active && band <= kl && j >= 1 && j < cols;
      const bool in_pad = active && band <= kl + 1 && j >= 0 && j < cols;
      const int32_t mu = c + 1 < C ? m[c + 1] : mn;
      const int32_t du = c + 1 < C ? d[c + 1] : dn;
      const int32_t d_open = mu - goe;
      const int32_t d_ext = du - ge;
      dbits |= static_cast<uint64_t>(d_open < d_ext) << c;
      d[c] = imax(d_open, d_ext);
      diag[c] = m[c] + srow[tcls[base + dm]];
      const int32_t h = filled ? imax(imax(diag[c], d[c]), 0) : (in_pad ? 0 : kNeg);
      fmask |= static_cast<uint64_t>(filled) << c;
      pmask |= static_cast<uint64_t>(in_pad) << c;
      hc[c] = h;
      ex[c] = run;
      run = imax(run, h + dm * ge);
    }
    // Warp-wide exclusive prefix max of the lane totals.
    int32_t incl = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int32_t y = __shfl_up_sync(full, incl, s);
      if (lane >= s) incl = imax(incl, y);
    }
    int32_t wex = __shfl_up_sync(full, incl, 1);
    if (lane == 0) wex = kNeg;

    // The left neighbour of each lane's first cell is the previous lane's
    // last cell: compute that one first, then exchange it.
    int32_t last_i, last_m;
    {
      constexpr int c = C - 1;
      const int32_t dm = dm0 + c;
      const bool filled = (fmask >> c) & 1;
      const bool in_pad = (pmask >> c) & 1;
      last_i = filled ? imax(wex, ex[c]) - go - dm * ge : kNeg;
      last_m = filled ? imax(hc[c], last_i) : (in_pad ? 0 : kNeg);
    }
    int32_t ml = __shfl_up_sync(full, last_m, 1);
    int32_t il = __shfl_up_sync(full, last_i, 1);
    if (lane == 0) {
      ml = kNeg;
      il = kNeg;
    }

    // Stores of 8 cells (32 bits) when a lane's run is a multiple of 8,
    // else of 4 cells (16 bits), so every store is aligned.
    constexpr int G = C % 8 == 0 ? 8 : 4;
    uint8_t* row = tb_pair + static_cast<size_t>(i - 1) * HALF + dm0 / 2;
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int32_t dm = dm0 + c;
      const bool filled = (fmask >> c) & 1;
      const bool in_pad = (pmask >> c) & 1;
      const int32_t ic = filled ? imax(wex, ex[c]) - go - dm * ge : kNeg;
      const int32_t mc = filled ? imax(hc[c], ic) : (in_pad ? 0 : kNeg);
      int32_t bv = diag[c];
      uint32_t t = 0;
      if (d[c] > bv) t = 1;
      bv = imax(bv, d[c]);
      if (ic > bv) t = 2;
      bv = imax(bv, ic);
      if (bv <= 0 || !filled) t = 3;
      const uint32_t ibit = (ml - goe) < (il - ge);
      const uint32_t nib = t | (static_cast<uint32_t>((dbits >> c) & 1) << 2) | (ibit << 3);
      word |= nib << (4 * (c % G));
      if (c % G == G - 1) {
        if constexpr (G == 8) {
          *reinterpret_cast<uint32_t*>(row + (c / G) * 4) = word;
        } else {
          *reinterpret_cast<uint16_t*>(row + (c / G) * 2) = static_cast<uint16_t>(word);
        }
        word = 0;
      }
      if (filled && mc > tbest) {
        tbest = mc;
        tbi = i;
        tbdm = dm;
      }
      ml = mc;
      il = ic;
      m[c] = mc;
    }
  }

  // Reduce (value desc, row asc, dm asc) over the warp.
  if (tbest == 0) {
    tbi = INT_MAX;
    tbdm = INT_MAX;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int32_t v = __shfl_xor_sync(full, tbest, s);
    const int32_t oi = __shfl_xor_sync(full, tbi, s);
    const int32_t od = __shfl_xor_sync(full, tbdm, s);
    if (v > tbest || (v == tbest && (oi < tbi || (oi == tbi && od < tbdm)))) {
      tbest = v;
      tbi = oi;
      tbdm = od;
    }
  }
  __threadfence_block();
  __syncwarp();
  if (lane != 0) return;

  const int32_t best = tbest;
  const int32_t bi = best > 0 ? tbi : 0;
  const int32_t bj = best > 0 ? tbi - off + tbdm - k_pad - 1 : 0;

  // Traceback: the lax path's state machine over the packed bits.
  int32_t i = bi, j = bj, state = 0, matches = 0, mism = 0, gaps = 0;
  while (i > 0 && j > 0) {
    int32_t r = i - 1;
    r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
    int32_t dmv = j - (i - off) + k_pad + 1;
    dmv = dmv < 0 ? 0 : (dmv > W - 1 ? W - 1 : dmv);
    const uint8_t byte = tb_pair[static_cast<size_t>(r) * HALF + dmv / 2];
    const int32_t cell = (dmv & 1) ? (byte >> 4) : (byte & 15);
    const int32_t tb_m = cell & 3;
    const int32_t d_ext = (cell >> 2) & 1;
    const int32_t i_ext = (cell >> 3) & 1;
    if (state == 0) {
      if (tb_m == 3) break;
      if (tb_m == 0) {
        int32_t tj = j - 1 + pad;
        tj = tj < 0 ? 0 : (tj > T - 1 ? T - 1 : tj);
        if (qs[r] == traw[tj]) {
          ++matches;
        } else {
          ++mism;
        }
        --i;
        --j;
      } else {
        state = tb_m;
      }
    } else if (state == 1) {
      ++gaps;
      --i;
      if (d_ext == 0) state = 0;
    } else {
      ++gaps;
      --j;
      if (i_ext == 0) state = 0;
    }
  }
  outs.f[0][p] = best;
  outs.f[1][p] = matches;
  outs.f[2][p] = mism;
  outs.f[3][p] = gaps;
  outs.f[4][p] = i;
  outs.f[5][p] = bi;
  outs.f[6][p] = j;
  outs.f[7][p] = bj;
}

template <int C>
cudaError_t launch(cudaStream_t stream, dim3 grid, size_t smem, const uint8_t* q,
                   const int32_t* ql, const uint8_t* t, const int32_t* tl, const int32_t* off,
                   const int32_t* kl, const int32_t* rl, const int32_t* cl, const int32_t* sm,
                   int n_row, int n_col, int B, int R, int q_stride, int T, int32_t go,
                   int32_t ge, Outs outs, uint8_t* tb) {
  swg_kernel<C><<<grid, 32 * kWarps, smem, stream>>>(q, ql, t, tl, off, kl, rl, cl, sm, n_row,
                                                     n_col, B, R, q_stride, T, go, ge, outs, tb);
  return cudaGetLastError();
}

ffi::Error BandedSwgImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q, ffi::Buffer<ffi::S32> q_lens,
                         ffi::Buffer<ffi::U8> t, ffi::Buffer<ffi::S32> t_lens,
                         ffi::Buffer<ffi::S32> offsets, ffi::Buffer<ffi::S32> k_locals,
                         ffi::Buffer<ffi::S32> row_lut, ffi::Buffer<ffi::S32> col_lut,
                         ffi::Buffer<ffi::S32> small, ffi::ResultBuffer<ffi::S32> scores,
                         ffi::ResultBuffer<ffi::S32> matches, ffi::ResultBuffer<ffi::S32> mism,
                         ffi::ResultBuffer<ffi::S32> gaps, ffi::ResultBuffer<ffi::S32> q_starts,
                         ffi::ResultBuffer<ffi::S32> q_ends, ffi::ResultBuffer<ffi::S32> t_starts,
                         ffi::ResultBuffer<ffi::S32> t_ends, ffi::ResultBuffer<ffi::U8> tb,
                         int32_t gap_open, int32_t gap_extend) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  const auto bd = tb->dimensions();
  const auto sd = small.dimensions();
  if (qd.size() != 2 || td.size() != 2 || bd.size() != 3 || sd.size() != 2) {
    return ffi::Error::InvalidArgument("banded_swg: bad operand ranks");
  }
  const int B = static_cast<int>(qd[0]);
  const int q_stride = static_cast<int>(qd[1]);
  const int T = static_cast<int>(td[1]);
  const int R = static_cast<int>(bd[1]);
  const int W = static_cast<int>(bd[2]) * 2;
  const int n_row = static_cast<int>(sd[0]);
  const int n_col = static_cast<int>(sd[1]);
  if (B == 0) return ffi::Error::Success();
  if (td[0] != B || bd[0] != B || q_stride < R || T < W || W % 128 != 0 || W > 2048 ||
      n_row > kMaxRowClasses || n_col > kClassStride) {
    return ffi::Error::InvalidArgument("banded_swg: operands outside the kernel contract");
  }
  const size_t smem = static_cast<size_t>(n_row) * kClassStride * 4 + 512 +
                      static_cast<size_t>(kWarps) * (round16(R) + 2 * round16(T));
  if (smem > 48 * 1024) {
    return ffi::Error::InvalidArgument("banded_swg: rows/target too long for shared memory");
  }
  Outs outs{{scores->typed_data(), matches->typed_data(), mism->typed_data(), gaps->typed_data(),
             q_starts->typed_data(), q_ends->typed_data(), t_starts->typed_data(),
             t_ends->typed_data()}};
  const dim3 grid((B + kWarps - 1) / kWarps);
  cudaError_t err = cudaErrorInvalidValue;
#define KAPTIVE_SWG_CASE(CC)                                                                    \
  case CC:                                                                                      \
    err = launch<CC>(stream, grid, smem, q.typed_data(), q_lens.typed_data(), t.typed_data(),   \
                     t_lens.typed_data(), offsets.typed_data(), k_locals.typed_data(),          \
                     row_lut.typed_data(), col_lut.typed_data(), small.typed_data(), n_row,     \
                     n_col, B, R, q_stride, T, gap_open, gap_extend, outs, tb->typed_data()); \
    break;
  switch (W / 32) {
    KAPTIVE_SWG_CASE(4)
    KAPTIVE_SWG_CASE(8)
    KAPTIVE_SWG_CASE(12)
    KAPTIVE_SWG_CASE(16)
    KAPTIVE_SWG_CASE(20)
    KAPTIVE_SWG_CASE(24)
    KAPTIVE_SWG_CASE(28)
    KAPTIVE_SWG_CASE(32)
    KAPTIVE_SWG_CASE(36)
    KAPTIVE_SWG_CASE(40)
    KAPTIVE_SWG_CASE(44)
    KAPTIVE_SWG_CASE(48)
    KAPTIVE_SWG_CASE(52)
    KAPTIVE_SWG_CASE(56)
    KAPTIVE_SWG_CASE(60)
    KAPTIVE_SWG_CASE(64)
    default:
      break;
  }
#undef KAPTIVE_SWG_CASE
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("banded_swg launch: ") + cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(KaptiveBandedSwg, BandedSwgImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()   // q_codes (B, rows)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // q_lens (B,)
                                  .Arg<ffi::Buffer<ffi::U8>>()   // t_codes (B, T)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // t_lens (B,)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // offsets (B,)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // k_locals (B,)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // row_lut (256,)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // col_lut (256,)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // class matrix
                                  .Ret<ffi::Buffer<ffi::S32>>()  // scores
                                  .Ret<ffi::Buffer<ffi::S32>>()  // matches
                                  .Ret<ffi::Buffer<ffi::S32>>()  // mismatches
                                  .Ret<ffi::Buffer<ffi::S32>>()  // gaps
                                  .Ret<ffi::Buffer<ffi::S32>>()  // q_starts
                                  .Ret<ffi::Buffer<ffi::S32>>()  // q_ends
                                  .Ret<ffi::Buffer<ffi::S32>>()  // t_starts
                                  .Ret<ffi::Buffer<ffi::S32>>()  // t_ends
                                  .Ret<ffi::Buffer<ffi::U8>>()   // traceback scratch
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));
