// Kernels B2 and B3: per-sample 2-D correlation over run lists built on the
// card, with an optional random-mix epilogue in the store.
//
// Replaces the TPU kernels
//   B2 tsr_tpu/kernels/blur_pallas.py::filter2d_pallas_sparse
//      (body _sparse_kernel_body, blur_pallas.py:110-131) and
//   B3 tsr_tpu/kernels/blur_pallas.py::filter2d_pallas
//      (body _blur_kernel_body, blur_pallas.py:33-52).
// Both compute cv2.filter2D semantics (correlation, no kernel flip,
// BORDER_REFLECT_101, anchor a = K/2, even K included) on a float32 NHWC
// batch with 1-4 channels:
//   out[b,h,w,c] = sum_ij k_b[i,j] * x[b, refl(h + i - a), refl(w + j - a), c]
//
// Two __global__s per call, on the caller's stream:
// 1. build_runs_kernel, one small CTA per sample, turns the sample's [K,K]
//    weights into a run list in a scratch buffer: a run is a row di, a
//    start column dj0, a length L and L weights. B2 (sparse) keeps, for each
//    row that has a nonzero tap, the span from its first to its last
//    nonzero tap, and skips empty rows; zero taps add nothing, so B2 is the
//    exact correlation for any kernel (the TPU kernel keeps the top 3K taps
//    by value, which is exact only when they cover the nonzeros). B3
//    (dense) makes every row one run of length K.
// 2. blur_runs_kernel computes the correlation from those runs.
//
// Modes of the main kernel:
// - float out (filter2d): out = the correlation.
// - random-mix epilogue (the mix's blur): given the mix's no-blur image f
//   and a per-sample gate, writes the mix's final uint8: saturate(rint(acc))
//   for a sample whose gate is on (cvRound as torch.round, half to even),
//   clip01_to_uint8(f) with the 1e-3 snap of ops/image.py for a sample whose
//   gate is off; those samples' CTAs skip the taps and read no blur input.
//
// Bound on the H100 (64 x 224 x 224 x 3, K = 15):
// - B2, float out: bytes, one read and one write of the fp32 batch
//   (2 x 38.5 MB); a motion kernel has about 2.7 nonzero taps per unit of
//   degree, far below the fp32 rate.
// - B2 with the epilogue: bytes, per sample either the fp32 blur input
//   (gate on) or the fp32 f (gate off), plus the uint8 output (at most
//   38.5 + 38.5 + 9.6 MB; the run's gates decide which half is read).
// - B3: fp32 operations, 2 x 225 per output. No tensor cores: TF32 would
//   round the weights (1/degree) to 10 bits and move cvRound's result.
//
// Design against those bounds:
// - A CTA of 4 warps takes one sample and a column band of 56 outputs, and
//   walks kStepsPerCta steps of 16 output rows down it, so the run list is
//   loaded once per CTA. The halo rows live in a ring in shared memory: a
//   step loads only its 16 new input rows (the K-1 rows it shares with the
//   step above stay), with cp.async, while the step before it computes.
//   Each input row crosses from L2 about (16 S + K - 1) / (16 S) times for
//   S steps, instead of (16 + K - 1) / 16 times for tiles loaded whole.
// - The halo keeps the NHWC interleaving of global memory: a row's interior
//   is copied as 16-byte cp.async chunks (the shared row is shifted so that
//   shared and global addresses agree modulo 16 bytes); only the K-1
//   reflected border columns are copied one float at a time, with one
//   branch-free reflection (the wrapper requires K/2 < H and K/2 < W, as
//   the plain version's reflect pad does) and no per-element division.
// - Register-blocked strips: a thread owns kP = 7 adjacent outputs of every
//   channel in one row. For a run of length L it reads the kP + L - 1 tile
//   values of a channel into registers once and applies the run's L weights
//   (read as float4 broadcasts, shared by the channels) from registers:
//   kP * L FMAs per kP + L - 1 shared loads. For compile-time K (15, the
//   mix; 10, the demo) a full-width run takes one fully unrolled body;
//   other runs and run-time K go in unrolled chunks of 4 taps.
// - Banks: a warp is 8 strips across x 4 rows. With a strip stride of
//   7 * 3 floats and a row stride of 8 or 24 mod 32 floats (ring length a
//   multiple of 4, so the wrap keeps it), the 32 lanes of a warp hit 32
//   distinct banks for C = 3 (and C = 1).
// - Four CTAs an SM (43 KB of shared memory each at K = 15, C = 3), up to
//   128 registers a thread (the launch bound). The taps are bound by
//   shared-memory loads and instruction slots, not by device memory, and
//   need the warps: three CTAs an SM measured 30 % slower; five, at 96
//   registers, the same.
// - The outputs are staged in ring rows that no later step reads and
//   written row by row as float4 (uchar4 for the epilogue) where aligned.
//   A gate-off CTA of the epilogue starts the loads of 8 rows of f before
//   it converts any of them.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 7;                 // outputs per strip
constexpr int kStrips = 8;            // strips across a band
constexpr int kTileW = kP * kStrips;  // 56 outputs
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileH = 4 * kWarps;    // output rows per step; a warp takes 4
constexpr int kStepsPerCta = 7;

// Run-list layout per sample, in 32-bit words (the wrapper sizes the scratch
// with the same formula): [0] run count, [4 + 4r .. 4 + 4r + 3] run r as
// {di, dj0, L, 0}, then run r's weights at 4 + 4K + r * KP, zero-padded to
// KP = K rounded up to 4 so each run starts 16-byte aligned.
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int run_words(int k) {
  return 4 + 4 * k + k * pad4(k);
}

// Ring rows: one step's K-1+16 input rows plus the next step's 16, rounded
// up to a multiple of 4 so that consecutive slots stay on distinct banks
// across the wrap.
__host__ __device__ constexpr int ring_rows(int k) {
  return pad4(2 * kTileH + k - 1);
}

// Shared row stride in floats: room for the halo row plus a 0-3 float shift,
// rounded up to 8 or 24 mod 32 (conflict-free strips, a multiple of 16
// bytes; 216 floats at K = 15, C = 3).
__host__ __device__ constexpr int row_stride(int ksize, int channels) {
  const int r = (3 + (kTileW + ksize - 1) * channels + 7) & ~7;
  return r % 16 == 0 ? r + 8 : r;
}

// One reflection is enough: the wrapper requires K/2 < n.
__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// One CTA per sample. Each thread takes some of the K*K taps and widens its
// row's span of nonzero taps with shared-memory atomics (B3: every row is
// whole); a row's run index is the number of earlier rows that have a run;
// then the threads write the runs' weights, zero-padded, in parallel. No
// thread walks a row, so the pass is one read of the weights deep.
__global__ void build_runs_kernel(const float* __restrict__ kernels,
                                  int64_t kstride, int ksize, int dense,
                                  float* __restrict__ runs) {
  extern __shared__ __align__(16) float smem[];
  int* s_lo = reinterpret_cast<int*>(smem);  // [K] first nonzero column
  int* s_hi = s_lo + ksize;                  // [K] last one, -1: no run
  int* s_idx = s_hi + ksize;                 // [K] run index, -1: no run
  const int b = blockIdx.x;
  const float* kb = kernels + b * kstride;
  float* rb = runs + static_cast<int64_t>(b) * run_words(ksize);
  int* meta = reinterpret_cast<int*>(rb);
  float* wts = rb + 4 + 4 * ksize;
  const int kp = pad4(ksize);
  for (int i = threadIdx.x; i < ksize; i += blockDim.x) {
    s_lo[i] = dense ? 0 : ksize;
    s_hi[i] = dense ? ksize - 1 : -1;
  }
  __syncthreads();
  if (!dense) {
    for (int e = threadIdx.x; e < ksize * ksize; e += blockDim.x) {
      if (kb[e] != 0.0f) {
        const int i = e / ksize;
        atomicMin(s_lo + i, e - i * ksize);
        atomicMax(s_hi + i, e - i * ksize);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ksize; i += blockDim.x) {
    int idx = 0;
    for (int r = 0; r < i; ++r) idx += s_hi[r] >= 0;
    const bool has_run = s_hi[i] >= 0;
    s_idx[i] = has_run ? idx : -1;
    if (has_run) {
      meta[4 + 4 * idx] = i;
      meta[4 + 4 * idx + 1] = s_lo[i];
      meta[4 + 4 * idx + 2] = s_hi[i] - s_lo[i] + 1;
      meta[4 + 4 * idx + 3] = 0;
    }
    if (i == ksize - 1) meta[0] = idx + has_run;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ksize * kp; e += blockDim.x) {
    const int i = e / kp, l = e - i * kp;
    if (s_idx[i] < 0) continue;
    const int lo = s_lo[i];
    wts[s_idx[i] * kp + l] = l <= s_hi[i] - lo ? kb[i * ksize + lo + l] : 0.0f;
  }
}

// acc[c][p] += sum_l w[l] * src[(p + l) * kC + c] for a run of length kL.
template <int kL, int kC>
__device__ __forceinline__ void apply_run(const float* src, const float* w,
                                          float (&acc)[kC][kP]) {
  float wr[pad4(kL)];
#pragma unroll
  for (int i = 0; i < pad4(kL) / 4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(w)[i];
    wr[4 * i] = t.x; wr[4 * i + 1] = t.y; wr[4 * i + 2] = t.z; wr[4 * i + 3] = t.w;
  }
  // every channel's window first: the loads go out back to back and the
  // FMAs of one channel hide the latency of the next
  float v[kC][kP + kL - 1];
#pragma unroll
  for (int j = 0; j < kP + kL - 1; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c][j] = src[j * kC + c];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int l = 0; l < kL; ++l)
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[c][p] = fmaf(wr[l], v[c][p + l], acc[c][p]);
}

// Any run: a full-width run (every B3 run at compile-time K) in one
// unrolled body; any other in unrolled chunks of 4 taps and a 1-3 tap
// remainder, so the code a warp jumps between stays small.
template <int kK, int kC>
__device__ __forceinline__ void apply_any(const float* src, const float* w,
                                          int len, float (&acc)[kC][kP]) {
  if constexpr (kK > 4) {
    if (len == kK) {
      apply_run<kK, kC>(src, w, acc);
      return;
    }
  }
  int l = 0;
  for (; l + 4 <= len; l += 4) apply_run<4, kC>(src + l * kC, w + l, acc);
  switch (len - l) {
    case 1: apply_run<1, kC>(src + l * kC, w + l, acc); break;
    case 2: apply_run<2, kC>(src + l * kC, w + l, acc); break;
    case 3: apply_run<3, kC>(src + l * kC, w + l, acc); break;
    default: break;
  }
}

__device__ __forceinline__ uint8_t saturate_rint(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// ops/image.py::clip01_to_uint8: trunc(snap(x * 255)) clipped to [0, 255].
__device__ __forceinline__ uint8_t clip01_to_uint8(float x) {
  float s = __fmul_rn(x, 255.0f);
  const float r = rintf(s);
  if (fabsf(__fsub_rn(s, r)) <= 1e-3f) s = r;
  return static_cast<uint8_t>(fminf(fmaxf(truncf(s), 0.0f), 255.0f));
}

// Where one sample's band sits: its input columns and the ring's geometry.
struct Band {
  int height, width, ksize, w0, vw, rs, nring;
  int64_t sample0;  // the sample's first float
  int row0;         // input row of ring position 0 (may be negative)
};

// Start the cp.async copies of input rows [pos, pos + n) of the band (ring
// positions, counted from the band's first input row) into their ring
// slots, and record each slot's 0-3 float shift.
template <int kC>
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          const Band& bd, int pos, int n,
                                          float* ring, int* shift) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = bd.w0 - bd.ksize / 2;  // input column of tile column 0
  const int ncols = bd.vw + bd.ksize - 1;
  const int clo = max(c0, 0), chi = min(c0 + ncols, bd.width);
  const int nleft = clo - c0, nright = c0 + ncols - chi;
  const int ninner = (chi - clo) * kC;
  const uintptr_t xw = reinterpret_cast<uintptr_t>(x) >> 2;
  for (int r = warp; r < n; r += kWarps) {
    const int slot = (pos + r) % bd.nring;
    const int gh = reflect101(bd.row0 + pos + r, bd.height);
    const int64_t rowbase = bd.sample0 + static_cast<int64_t>(gh) * bd.width * kC;
    const int64_t gstart = rowbase + static_cast<int64_t>(c0) * kC;
    // shared and global addresses agree modulo 16 bytes
    const int sh = static_cast<int>((xw + static_cast<uintptr_t>(gstart)) & 3);
    if (lane == 0) shift[slot] = sh;
    float* drow = ring + slot * bd.rs + sh;  // tile column j at drow[j * kC]
    // interior: 16-byte chunks between a 0-3 float head and tail
    const int d0 = nleft * kC;  // interior's offset in the row
    const float* src = x + gstart + d0;
    const int head0 = (4 - static_cast<int>((xw + gstart + d0) & 3)) & 3;
    const int head = head0 < ninner ? head0 : ninner;
    const int tail = (ninner - head) & 3;
    for (int e = head + 4 * lane; e < ninner - tail; e += 128)
      __pipeline_memcpy_async(drow + d0 + e, src + e, 16);
    if (lane < head) __pipeline_memcpy_async(drow + d0 + lane, src + lane, 4);
    if (lane < tail) {
      const int e = ninner - tail + lane;
      __pipeline_memcpy_async(drow + d0 + e, src + e, 4);
    }
    // reflected border columns, one float each
    for (int e = lane; e < (nleft + nright) * kC; e += 32) {
      const int jj = e / kC, c = e - jj * kC;  // kC is a compile-time constant
      const int j = jj < nleft ? jj : chi - c0 + (jj - nleft);
      const int64_t gsrc = rowbase + static_cast<int64_t>(reflect101(c0 + j, bd.width)) * kC + c;
      __pipeline_memcpy_async(drow + j * kC + c, x + gsrc, 4);
    }
  }
}

template <int kC, int kK>
__global__ void __launch_bounds__(kThreads, 4)
blur_runs_kernel(const float* __restrict__ x, const float* __restrict__ runs,
                 const float* __restrict__ f, const uint8_t* __restrict__ gate,
                 int height, int width, int ksize_rt,
                 float* __restrict__ out, uint8_t* __restrict__ out_u8) {
  extern __shared__ __align__(16) float smem[];
  Band bd;
  bd.height = height;
  bd.width = width;
  bd.ksize = kK > 0 ? kK : ksize_rt;
  bd.w0 = blockIdx.x * kTileW;
  bd.vw = min(kTileW, width - bd.w0);
  bd.rs = row_stride(bd.ksize, kC);
  bd.nring = ring_rows(bd.ksize);
  bd.sample0 = static_cast<int64_t>(blockIdx.z) * height * width * kC;
  const int b = blockIdx.z;
  const int hs = blockIdx.y * kStepsPerCta * kTileH;  // first output row
  const int nsteps = min(kStepsPerCta, (height - hs + kTileH - 1) / kTileH);
  bd.row0 = hs - bd.ksize / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_len = bd.vw * kC;
  // rows go out as float4 (uchar4) where the row and the pointers allow
  const bool vec_ok =
      (row_len & 3) == 0 && (reinterpret_cast<uintptr_t>(out_u8) & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(f)) & 15) == 0;

  if (out_u8 != nullptr && gate[b] == 0) {
    // gate off: the mix keeps f; no taps, no blur input. A warp takes
    // kRowsOff rows at a time and starts all their loads (a band row is at
    // most 56 float4) before it converts any, so loads overlap.
    constexpr int kRowsOff = 8;
    const int he = min(height, hs + nsteps * kTileH);
    const bool vec = vec_ok && ((width * kC) & 3) == 0 && (bd.sample0 & 3) == 0 &&
                     ((bd.w0 * kC) & 3) == 0;
    for (int h = hs + warp * kRowsOff; h < he; h += kWarps * kRowsOff) {
      if (!vec) {
        for (int r = h; r < min(h + kRowsOff, he); ++r) {
          const int64_t o = bd.sample0 + (static_cast<int64_t>(r) * width + bd.w0) * kC;
          for (int e = lane; e < row_len; e += 32) out_u8[o + e] = clip01_to_uint8(f[o + e]);
        }
        continue;
      }
      float4 v[kRowsOff][2];
#pragma unroll
      for (int u = 0; u < kRowsOff; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 4 * (lane + 32 * k);
          if (h + u < he && e < row_len)
            v[u][k] = *reinterpret_cast<const float4*>(
                f + bd.sample0 + (static_cast<int64_t>(h + u) * width + bd.w0) * kC + e);
        }
#pragma unroll
      for (int u = 0; u < kRowsOff; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 4 * (lane + 32 * k);
          if (h + u < he && e < row_len) {
            uchar4 q;
            q.x = clip01_to_uint8(v[u][k].x); q.y = clip01_to_uint8(v[u][k].y);
            q.z = clip01_to_uint8(v[u][k].z); q.w = clip01_to_uint8(v[u][k].w);
            *reinterpret_cast<uchar4*>(
                out_u8 + bd.sample0 + (static_cast<int64_t>(h + u) * width + bd.w0) * kC + e) = q;
          }
        }
    }
    return;
  }

  const int ksize = bd.ksize;
  const int rw = run_words(ksize);
  const int kp = pad4(ksize);
  float* s_runs = smem;                                         // [rw]
  float* ring = s_runs + rw;                                    // [nring][rs]
  int* shift = reinterpret_cast<int*>(ring + bd.nring * bd.rs);  // [nring]

  const float* rsrc = runs + static_cast<int64_t>(b) * rw;
  for (int i = 4 * threadIdx.x; i < rw; i += 4 * kThreads)
    __pipeline_memcpy_async(s_runs + i, rsrc + i, 16);
  // step 0's input rows
  load_rows<kC>(x, bd, 0, min(kTileH, height - hs) + ksize - 1, ring, shift);
  __pipeline_commit();

  const int* meta = reinterpret_cast<const int*>(s_runs);
  const int4* runs4 = reinterpret_cast<const int4*>(meta) + 1;
  const float* s_wts = s_runs + 4 + 4 * ksize;
  const int g = lane & 7;
  const int row = warp * 4 + (lane >> 3);  // output row within the step
  const float* strip = ring + g * kP * kC;  // this strip's first column

  for (int t = 0; t < nsteps; ++t) {
    const int h0 = hs + t * kTileH;
    const int vh = min(kTileH, height - h0);
    const int base = (t * kTileH) % bd.nring;  // ring slot of the step's first row
    __pipeline_wait_prior(0);
    // the step's rows have landed, and the last step's stores have read its
    // staged rows, which the next rows may now overwrite
    __syncthreads();
    if (t + 1 < nsteps) {
      load_rows<kC>(x, bd, (t + 1) * kTileH + ksize - 1,
                    min(kTileH, height - h0 - kTileH), ring, shift);
      __pipeline_commit();
    }

    float acc[kC][kP];
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[c][p] = 0.0f;
    const int nruns = meta[0];
    for (int r = 0; r < nruns; ++r) {
      const int4 m = runs4[r];
      int slot = base + row + m.x;
      if (slot >= bd.nring) slot -= bd.nring;
      // a row past the image's last (ragged step) reads a slot never loaded:
      // its shift is masked to stay inside the row, its outputs are dropped
      const float* src = strip + slot * bd.rs + (shift[slot] & 3) + m.y * kC;
      apply_any<kK, kC>(src, s_wts + r * kp, m.z, acc);
    }
    // every strip has read the step's rows: stage the outputs in the ring
    // slots of its first 16 input rows, which no later step reads
    __syncthreads();
    int srow = base + row;
    if (srow >= bd.nring) srow -= bd.nring;
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int c = 0; c < kC; ++c) ring[srow * bd.rs + (g * kP + p) * kC + c] = acc[c][p];
    __syncthreads();
    for (int r = warp; r < vh; r += kWarps) {
      const int64_t o = bd.sample0 + (static_cast<int64_t>(h0 + r) * width + bd.w0) * kC;
      int sl = base + r;
      if (sl >= bd.nring) sl -= bd.nring;
      const float* s = ring + sl * bd.rs;
      const bool vec = vec_ok && (o & 3) == 0;
      if (out_u8 != nullptr) {
        if (vec) {
          for (int e = 4 * lane; e < row_len; e += 128) {
            const float4 v = *reinterpret_cast<const float4*>(s + e);
            uchar4 q;
            q.x = saturate_rint(v.x); q.y = saturate_rint(v.y);
            q.z = saturate_rint(v.z); q.w = saturate_rint(v.w);
            *reinterpret_cast<uchar4*>(out_u8 + o + e) = q;
          }
        } else {
          for (int e = lane; e < row_len; e += 32) out_u8[o + e] = saturate_rint(s[e]);
        }
      } else if (vec) {
        for (int e = 4 * lane; e < row_len; e += 128)
          *reinterpret_cast<float4*>(out + o + e) = *reinterpret_cast<const float4*>(s + e);
      } else {
        for (int e = lane; e < row_len; e += 32) out[o + e] = s[e];
      }
    }
  }
}

template <int kC, int kK>
cudaError_t launch_main(const float* x, const float* runs, const float* f,
                        const uint8_t* gate, int batch, int height, int width,
                        int ksize, float* out, uint8_t* out_u8,
                        cudaStream_t stream) {
  const int nring = ring_rows(ksize);
  const size_t smem = sizeof(float) * (run_words(ksize) +
                                       static_cast<size_t>(nring) * row_stride(ksize, kC)) +
                      sizeof(int) * nring;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_runs_kernel<kC, kK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int steps = (height + kTileH - 1) / kTileH;
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (steps + kStepsPerCta - 1) / kStepsPerCta, batch);
  blur_runs_kernel<kC, kK><<<grid, kThreads, smem, stream>>>(
      x, runs, f, gate, height, width, ksize, out, out_u8);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch_k(const float* x, const float* runs, const float* f,
                     const uint8_t* gate, int batch, int height, int width,
                     int ksize, float* out, uint8_t* out_u8, cudaStream_t s) {
  switch (ksize) {
    case 15: return launch_main<kC, 15>(x, runs, f, gate, batch, height, width, ksize, out, out_u8, s);
    case 10: return launch_main<kC, 10>(x, runs, f, gate, batch, height, width, ksize, out, out_u8, s);
    default: return launch_main<kC, 0>(x, runs, f, gate, batch, height, width, ksize, out, out_u8, s);
  }
}

int blur(int dense, const void* x, const void* kernels, int64_t kstride,
         void* runs, int64_t runs_words, const void* f, const void* gate,
         int batch, int height, int width, int channels, int ksize, void* out,
         void* out_u8, void* stream) {
  const bool epilogue = out_u8 != nullptr;
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 ||
      ksize <= 0 || ksize / 2 >= height || ksize / 2 >= width ||
      runs_words < static_cast<int64_t>(batch) * run_words(ksize) ||
      (out != nullptr) == epilogue ||
      epilogue != (f != nullptr && gate != nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const size_t prep_smem = sizeof(int) * 3 * ksize;
  build_runs_kernel<<<batch, threads, prep_smem, s>>>(
      static_cast<const float*>(kernels), kstride, ksize, dense,
      static_cast<float*>(runs));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* xf = static_cast<const float*>(x);
  const auto* rf = static_cast<const float*>(runs);
  const auto* ff = static_cast<const float*>(f);
  const auto* gu = static_cast<const uint8_t*>(gate);
  auto* of = static_cast<float*>(out);
  auto* ou = static_cast<uint8_t*>(out_u8);
  switch (channels) {
    case 1: return launch_k<1>(xf, rf, ff, gu, batch, height, width, ksize, of, ou, s);
    case 2: return launch_k<2>(xf, rf, ff, gu, batch, height, width, ksize, of, ou, s);
    case 3: return launch_k<3>(xf, rf, ff, gu, batch, height, width, ksize, of, ou, s);
    case 4: return launch_k<4>(xf, rf, ff, gu, batch, height, width, ksize, of, ou, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B2: runs over each row's nonzero span. B3: every row one run of K taps.
// `out` (float32) or `out_u8` with `f` and `gate` (the epilogue), not both.
extern "C" int tsr_blur_sparse(const void* x, const void* kernels,
                               int64_t kstride, void* runs, int64_t runs_words,
                               const void* f, const void* gate, int batch,
                               int height, int width, int channels, int ksize,
                               void* out, void* out_u8, void* stream) {
  return blur(0, x, kernels, kstride, runs, runs_words, f, gate, batch,
              height, width, channels, ksize, out, out_u8, stream);
}

extern "C" int tsr_blur_dense(const void* x, const void* kernels,
                              int64_t kstride, void* runs, int64_t runs_words,
                              const void* f, const void* gate, int batch,
                              int height, int width, int channels, int ksize,
                              void* out, void* out_u8, void* stream) {
  return blur(1, x, kernels, kstride, runs, runs_words, f, gate, batch,
              height, width, channels, ksize, out, out_u8, stream);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
