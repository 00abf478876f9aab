// Kernel B1: fused fog + noise prologue of the random-mix distortion.
//
// Replaces the TPU kernel tsr_tpu/kernels/distort.py::fused_fog_noise
// (body _kernel, distort.py:54-78). One pass over a uint8 batch
// [B, H, W, C]: per-sample gated fog x*t + A*(1-t), per-sample gated
// additive noise sigma*N(0,1), then the pre-blur uint8 round-trip
// pre = clip(trunc(snap(x*255)), 0, 255). Writes both float32 outputs:
// f (the no-blur branch) and pre (the blur's input).
//
// Bound on the H100: memory. Per element it reads 1 byte and writes 8;
// the arithmetic (a Philox round function and Box-Muller per 4 elements)
// is far below the card's rate. The design therefore only has to stream:
// each thread owns 4 contiguous elements of one sample (one uchar4 load,
// two float4 stores when the row length allows it), reads the per-sample
// scalars from global memory (they stay in L1/L2; there is no scalar
// prefetch to port), and keeps nothing else in memory.
//
// Randomness: counter-based Philox4x32-10 keyed by the 64-bit seed, with
// counter (quad index, row0 + sample): row0 is the call's first sample in
// its noise group, so a batch split into calls (a rank's rows) draws the
// whole batch's stream, and row0 = 0 is the stream of one whole call. One
// call gives 4 uniforms in
// [2^-24, 1 - 2^-24] (never 0, so log never sees 0) and Box-Muller turns
// them into 4 normals. The stream differs from the TPU's on-chip PRNG by
// design; only its distribution is held to the reference.
//
// Rounding: the deterministic part uses the _rn intrinsics so nvcc cannot
// contract it into FMAs; with sigma = 0 the kernel matches the plain
// PyTorch version (tsr_tpu_torch/kernels/distort.py::fog_noise_plain)
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, ctr.x);
    const uint32_t lo0 = kPhiloxM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, ctr.z);
    const uint32_t lo1 = kPhiloxM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kPhiloxW0;
    key.y += kPhiloxW1;
  }
  return ctr;
}

// 23 random bits -> (k + 0.5) * 2^-23, exact in float: [2^-24, 1 - 2^-24].
__device__ __forceinline__ float uniform_open(uint32_t bits) {
  return static_cast<float>(bits >> 9) * 1.1920928955078125e-7f +
         5.9604644775390625e-8f;
}

__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float* n0, float* n1) {
  const float r = sqrtf(-2.0f * logf(uniform_open(b1)));
  float s, c;
  sincospif(2.0f * uniform_open(b2), &s, &c);
  *n0 = r * c;
  *n1 = r * s;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fog_noise_kernel(const uint8_t* __restrict__ clean,
                 const int32_t* __restrict__ gate_fog,
                 const float* __restrict__ t,
                 const int32_t* __restrict__ gate_noise,
                 const float* __restrict__ sigma,
                 const int64_t* __restrict__ seed, float atmosphere,
                 int64_t n, int64_t row0, float* __restrict__ f_out,
                 float* __restrict__ pre_out) {
  const int b = blockIdx.y;
  const int64_t quad = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t e0 = quad * 4;
  if (e0 >= n) return;
  const int64_t base = static_cast<int64_t>(b) * n + e0;
  const int cnt = n - e0 < 4 ? static_cast<int>(n - e0) : 4;

  const bool fog = gate_fog[b] != 0;
  const bool noisy = gate_noise[b] != 0;
  const float tb = t[b];
  const float fog_add = __fmul_rn(atmosphere, __fsub_rn(1.0f, tb));
  const float sg = sigma[b];

  float nz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (noisy) {
    const uint64_t s = static_cast<uint64_t>(seed[0]);
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(quad),
                   static_cast<uint32_t>(quad >> 32),
                   static_cast<uint32_t>(b + row0), 0u),
        make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)));
    box_muller(bits.x, bits.y, &nz[0], &nz[1]);
    box_muller(bits.z, bits.w, &nz[2], &nz[3]);
  }

  uint8_t u[4] = {0, 0, 0, 0};
  if (kVec) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(clean + base);
    u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
  } else {
    for (int k = 0; k < cnt; ++k) u[k] = clean[base + k];
  }

  float fv[4], pv[4];
  const float inv255 = 1.0f / 255.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float x = __fmul_rn(static_cast<float>(u[k]), inv255);
    if (fog) x = __fadd_rn(__fmul_rn(x, tb), fog_add);
    if (noisy) x = __fadd_rn(x, __fmul_rn(sg, nz[k]));
    fv[k] = x;
    // snap near-integers like ops.image.scale255, then trunc + clip
    float s = __fmul_rn(x, 255.0f);
    const float r = rintf(s);
    if (fabsf(__fsub_rn(s, r)) <= 1e-3f) s = r;
    pv[k] = fminf(fmaxf(truncf(s), 0.0f), 255.0f);
  }

  if (kVec) {
    *reinterpret_cast<float4*>(f_out + base) = make_float4(fv[0], fv[1], fv[2], fv[3]);
    *reinterpret_cast<float4*>(pre_out + base) = make_float4(pv[0], pv[1], pv[2], pv[3]);
  } else {
    for (int k = 0; k < cnt; ++k) {
      f_out[base + k] = fv[k];
      pre_out[base + k] = pv[k];
    }
  }
}

}  // namespace

extern "C" int tsr_fog_noise(const void* clean, const void* gate_fog,
                             const void* t, const void* gate_noise,
                             const void* sigma, const void* seed,
                             float atmosphere, int batch, int64_t n,
                             int64_t row0, void* f_out, void* pre_out,
                             void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return cudaErrorInvalidValue;
  const int64_t quads = (n + 3) / 4;
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(clean) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(f_out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pre_out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(clean);
  const auto* gf = static_cast<const int32_t*>(gate_fog);
  const auto* tt = static_cast<const float*>(t);
  const auto* gn = static_cast<const int32_t*>(gate_noise);
  const auto* sg = static_cast<const float*>(sigma);
  const auto* sd = static_cast<const int64_t*>(seed);
  auto* f = static_cast<float*>(f_out);
  auto* p = static_cast<float*>(pre_out);
  if (vec) {
    fog_noise_kernel<true><<<grid, kThreads, 0, s>>>(c, gf, tt, gn, sg, sd,
                                                     atmosphere, n, row0, f, p);
  } else {
    fog_noise_kernel<false><<<grid, kThreads, 0, s>>>(c, gf, tt, gn, sg, sd,
                                                      atmosphere, n, row0, f, p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
