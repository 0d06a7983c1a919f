// GPU kernels for the two dynamic-programming recurrences of the pipeline,
// called from JAX through the XLA foreign function interface.
//
//   fg_pairhmm_fwd   PairHMM forward likelihood with scalar transitions
//                    (ops/pairhmm.py, the HaplotypeCaller/Mutect2 path)
//   fg_sw_score      score-only local affine Smith-Waterman
//                    (ops/smith_waterman.py, the aligner's candidate ranking)
//
// Both use the same warp-strip wavefront.  One warp owns one pair.  The
// pair's read rows are cut into strips of 32; lane t of the warp holds row
// 32*s + t of strip s in registers.  At step k lane t computes hap/window
// column j = k - t + 1, so the 32 lanes sweep an anti-diagonal of the strip:
//
//   * the cell above (r-1, j) was computed by lane t-1 one step earlier and
//     arrives by __shfl_up_sync;
//   * the diagonal cell (r-1, j-1) is that lane's value from two steps back,
//     kept in a register;
//   * the cell to the left (r, j-1) is the lane's own previous value.
//
// Lane 31 writes the strip's last row into a per-warp shared-memory buffer
// and lane 0 of the next strip reads it back as its row above.  The read of
// column j happens at step j-1 and the overwrite of column j at step j+30, so
// one buffer serves every strip in place.
//
// Rows are added strip by strip, so the PairHMM rescaling check runs at each
// strip boundary: the next strip is a linear function of the handed-off row
// alone, and scaling that row by 2^100 scales every later cell exactly.
//
// Build: native/build_cuda.sh (run on first use by ops/gpu_kernels.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// Keep in step with RESCALE_THRESH / RESCALE_FACTOR / RESCALE_SHIFT_LOG10
// in ops/pairhmm.py.
constexpr float kRescaleThresh = 8.673617379884035e-19f;   // 2^-60
constexpr float kRescaleFactor = 1.2676506002282294e30f;   // 2^100
constexpr float kRescaleShiftLog10 = 30.10299956639812f;   // 100*log10(2)
constexpr float kInitial = 1.329227995784916e36f;          // 2^120

constexpr int kSwNeg = -(1 << 28);  // NEG in ops/sw_ref.py

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// read (B, R) u8, perr (B, R) f32, rlen (B,) i32, hap (B, H) u8, hlen (B,)
// i32 -> acc (B,) f32 (final-row mass, scaled) and shift (B,) f32 (log10 of
// the rescaling applied).  Shared memory per warp: (H+1) float2 hand-off
// cells, then H hap bytes.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
pairhmm_fwd_kernel(const uint8_t* __restrict__ read,
                   const float* __restrict__ perr,
                   const int32_t* __restrict__ rlen,
                   const uint8_t* __restrict__ hap,
                   const int32_t* __restrict__ hlen,
                   int B, int R, int H,
                   float a_mm, float a_im, float p_ins, float p_del,
                   float p_cont,
                   float* __restrict__ acc_out,
                   float* __restrict__ shift_out) {
  extern __shared__ float2 smem_f2[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warp leaves; the kernel has no block barrier

  float2* hand = smem_f2 + warp * (H + 1);
  uint8_t* hs = reinterpret_cast<uint8_t*>(smem_f2 + kWarpsPerBlock * (H + 1))
                + warp * H;

  const int rl = min(rlen[b], R);
  const int hl = min(hlen[b], H);
  for (int j = lane; j < hl; j += kWarp) hs[j] = hap[(size_t)b * H + j];
  __syncwarp();

  const float bound_dg = (kInitial / fmaxf((float)hlen[b], 1.0f)) * a_im;
  const int nstrips = (rl + kWarp - 1) / kWarp;
  float acc = 0.0f;
  float shift = 0.0f;

  for (int s = 0; s < nstrips; ++s) {
    const int r = s * kWarp + lane;
    const bool row_ok = r < rl;
    const int rc = row_ok ? read[(size_t)b * R + r] : 4;
    const float pe = row_ok ? perr[(size_t)b * R + r] : 0.0f;
    const float prior_match = 1.0f - pe;
    const float prior_mismatch = pe / 3.0f;
    const bool last_row = r == rl - 1;
    const bool hand_off = s + 1 < nstrips;

    // transition term of the row above at column j-1, for this lane's next
    // cell: column 0 is zero except for the D boundary above row 0
    float diag_in = (s == 0 && lane == 0) ? bound_dg : 0.0f;
    float left = 0.0f;     // M(r, j-1) * p_del + D(r, j-1) * p_cont
    float tdg_out = 0.0f;  // M*a_mm + (I+D)*a_im of this lane's last cell
    float tup_out = 0.0f;  // M*p_ins + I*p_cont of this lane's last cell

    const int nsteps = hl + kWarp - 1;
    for (int k = 0; k < nsteps; ++k) {
      const int j = k - lane + 1;
      float up_dg = __shfl_up_sync(kFull, tdg_out, 1);
      float up_up = __shfl_up_sync(kFull, tup_out, 1);
      if (lane == 0) {
        if (s == 0) {
          up_dg = bound_dg;  // D[0][j] = 2^120 / hap_len, M = I = 0
          up_up = 0.0f;
        } else if (j <= hl) {
          const float2 h = hand[j];
          up_dg = h.x;
          up_up = h.y;
        }
      }
      float tdg = 0.0f;
      float tup = 0.0f;
      if (j >= 1 && j <= hl) {
        const int hc = hs[j - 1];
        const bool match = (rc == hc) | (rc >= 4) | (hc >= 4);
        const float m = (match ? prior_match : prior_mismatch) * diag_in;
        const float i = up_up;
        const float d = left;
        left = m * p_del + d * p_cont;
        tdg = m * a_mm + (i + d) * a_im;
        tup = m * p_ins + i * p_cont;
        if (last_row) acc += m + i;
      }
      diag_in = up_dg;
      tdg_out = tdg;
      tup_out = tup;
      if (lane == kWarp - 1 && hand_off && j >= 1 && j <= hl)
        hand[j] = make_float2(tdg, tup);
      __syncwarp();
    }

    if (hand_off) {
      float mx = 0.0f;
      for (int j = lane + 1; j <= hl; j += kWarp)
        mx = fmaxf(mx, fmaxf(fabsf(hand[j].x), fabsf(hand[j].y)));
      mx = warp_max(mx);
      if (mx > 0.0f && mx < kRescaleThresh) {
        for (int j = lane + 1; j <= hl; j += kWarp) {
          hand[j].x *= kRescaleFactor;
          hand[j].y *= kRescaleFactor;
        }
        shift += kRescaleShiftLog10;
      }
      __syncwarp();
    }
  }

  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) {
    acc_out[b] = acc;
    shift_out[b] = shift;
  }
}

// read (B, R) u8, rlen (B,) i32, win (B, W) u8, wlen (B,) i32 -> best local
// score (B,) i32.  Shared memory per warp: (W+1) int2 hand-off cells (H, F),
// then W window bytes.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sw_score_kernel(const uint8_t* __restrict__ read,
                const int32_t* __restrict__ rlen,
                const uint8_t* __restrict__ win,
                const int32_t* __restrict__ wlen,
                int B, int R, int W,
                int match, int mismatch, int go, int ge,
                int32_t* __restrict__ score_out) {
  extern __shared__ int2 smem_i2[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;

  int2* hand = smem_i2 + warp * (W + 1);
  uint8_t* ws = reinterpret_cast<uint8_t*>(smem_i2 + kWarpsPerBlock * (W + 1))
                + warp * W;

  const int rl = min(rlen[b], R);
  const int wl = min(wlen[b], W);
  for (int j = lane; j < wl; j += kWarp) ws[j] = win[(size_t)b * W + j];
  __syncwarp();

  const int nstrips = (rl + kWarp - 1) / kWarp;
  int best = 0;

  for (int s = 0; s < nstrips; ++s) {
    const int r = s * kWarp + lane;
    const bool row_ok = r < rl;
    const int rc = row_ok ? read[(size_t)b * R + r] : 4;
    const bool hand_off = s + 1 < nstrips;

    int diag_in = 0;       // H(r-1, j-1)
    int h_left = 0;        // H(r, j-1)
    int e_left = kSwNeg;   // E(r, j-1)
    int h_out = 0;         // H of this lane's last cell
    int f_out = kSwNeg;    // F of this lane's last cell

    const int nsteps = wl + kWarp - 1;
    for (int k = 0; k < nsteps; ++k) {
      const int j = k - lane + 1;
      int up_h = __shfl_up_sync(kFull, h_out, 1);
      int up_f = __shfl_up_sync(kFull, f_out, 1);
      if (lane == 0) {
        if (s == 0 || j > wl) {
          up_h = 0;
          up_f = kSwNeg;
        } else {
          const int2 h = hand[j];
          up_h = h.x;
          up_f = h.y;
        }
      }
      int h = 0;
      int e = kSwNeg;
      int f = kSwNeg;
      if (row_ok && j >= 1 && j <= wl) {
        e = max(h_left - go, e_left - ge);
        f = max(up_h - go, up_f - ge);
        const int dg = diag_in + (rc == ws[j - 1] ? match : -mismatch);
        h = max(max(0, dg), max(e, f));
        best = max(best, h);
      }
      h_left = h;
      e_left = e;
      diag_in = up_h;
      h_out = h;
      f_out = f;
      if (lane == kWarp - 1 && hand_off && j >= 1 && j <= wl)
        hand[j] = make_int2(h, f);
      __syncwarp();
    }
  }

  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, o));
  if (lane == 0) score_out[b] = best;
}

int num_blocks(int64_t pairs) {
  return (int)((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error PairHmmFwdImpl(cudaStream_t stream,
                          ffi::Buffer<ffi::U8> read,
                          ffi::Buffer<ffi::F32> perr,
                          ffi::Buffer<ffi::S32> rlen,
                          ffi::Buffer<ffi::U8> hap,
                          ffi::Buffer<ffi::S32> hlen,
                          float a_mm, float a_im, float p_ins, float p_del,
                          float p_cont,
                          ffi::ResultBuffer<ffi::F32> acc,
                          ffi::ResultBuffer<ffi::F32> shift) {
  const auto rd = read.dimensions();
  const auto hd = hap.dimensions();
  if (rd.size() != 2 || hd.size() != 2 || rd[0] != hd[0])
    return ffi::Error::InvalidArgument("fg_pairhmm_fwd: want (B,R), (B,H)");
  const int64_t B = rd[0];
  const int R = (int)rd[1];
  const int H = (int)hd[1];
  if (B == 0) return ffi::Error::Success();
  const size_t smem = kWarpsPerBlock * ((H + 1) * sizeof(float2) + H);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(pairhmm_fwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  pairhmm_fwd_kernel<<<num_blocks(B), kWarp * kWarpsPerBlock, smem, stream>>>(
      read.typed_data(), perr.typed_data(), rlen.typed_data(),
      hap.typed_data(), hlen.typed_data(), (int)B, R, H, a_mm, a_im, p_ins,
      p_del, p_cont, acc->typed_data(), shift->typed_data());
  return launch_status();
}

ffi::Error SwScoreImpl(cudaStream_t stream,
                       ffi::Buffer<ffi::U8> read,
                       ffi::Buffer<ffi::S32> rlen,
                       ffi::Buffer<ffi::U8> win,
                       ffi::Buffer<ffi::S32> wlen,
                       int32_t match, int32_t mismatch, int32_t go,
                       int32_t ge,
                       ffi::ResultBuffer<ffi::S32> score) {
  const auto rd = read.dimensions();
  const auto wd = win.dimensions();
  if (rd.size() != 2 || wd.size() != 2 || rd[0] != wd[0])
    return ffi::Error::InvalidArgument("fg_sw_score: want (B,R), (B,W)");
  const int64_t B = rd[0];
  const int R = (int)rd[1];
  const int W = (int)wd[1];
  if (B == 0) return ffi::Error::Success();
  const size_t smem = kWarpsPerBlock * ((W + 1) * sizeof(int2) + W);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(sw_score_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  sw_score_kernel<<<num_blocks(B), kWarp * kWarpsPerBlock, smem, stream>>>(
      read.typed_data(), rlen.typed_data(), win.typed_data(),
      wlen.typed_data(), (int)B, R, W, match, mismatch, go, ge,
      score->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FgPairHmmFwd, PairHmmFwdImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Attr<float>("a_mm")
        .Attr<float>("a_im")
        .Attr<float>("p_ins")
        .Attr<float>("p_del")
        .Attr<float>("p_cont")
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FgSwScore, SwScoreImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Attr<int32_t>("match")
        .Attr<int32_t>("mismatch")
        .Attr<int32_t>("go")
        .Attr<int32_t>("ge")
        .Ret<ffi::Buffer<ffi::S32>>());
