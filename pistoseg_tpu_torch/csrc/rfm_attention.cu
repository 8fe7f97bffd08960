// Fused RFM affinity attention, forward, for Hopper (sm_90a).
//
//   out[n, j, c] = sum_i softmax_i(q[n, i, :] . k[n, j, :]) * v[n, i, c]
//
// The softmax runs over the FIRST index i (the affinity is column-
// normalised) and there is no 1/sqrt(D) scale.  Replaces the TPU kernel
// pistoseg_tpu/ops/pallas/rfm_attention.py::_kernel, launched by
// _rfm_attention_pallas (pl.pallas_call at :61).
//
// Design.  Flash-style with the roles turned round: the output column k_j
// plays the query and q_i the key.  One block per (image n, tile of BJ
// output columns j).  The block keeps its k_j tile in shared memory and
// walks i in tiles of BI rows: it stages the q_i and v_i tiles, forms the
// BI x BJ scores with IEEE float32 FMAs, and keeps a running max m_j and
// sum l_j per column (online softmax), rescaling the BJ x C accumulator
// whenever the max moves.  The L x L affinity never reaches device memory.
// The scores are not computed in TF32: the Pallas kernel pins
// Precision.HIGHEST because a reduced-precision pass moved scores by ~4e-2.
//
// Bound on an H100 SXM.  Per image 2 L^2 (D + C) FLOP plus L^2 exp; at
// N=64, L=1024, D=192, C=12 that is 27.4 GFLOP, 0.41 ms at the datasheet's
// 67 TFLOP/s of non-tensor FP32.  Inputs are ~101 MB, 30 us at 3.35 TB/s.
// So the kernel is bound by the FP32 pipes; this simple version keeps the
// FMA-to-shared-load ratio at 4x4 register tiles and does not reach that
// bound.  The lever for a later version is 3xTF32 wgmma (split each f32
// operand into a TF32 high and low part: ~f32 accuracy on the tensor cores).
//
// Shapes: q, k (N, L, D) f32 contiguous, D % 4 == 0, D <= MAX_D;
// v (N, L, C) f32 contiguous, 1 <= C <= MAX_C; out (N, L, C) f32.
// lse (N, L) f32, optional (null: not written): the per-column log-sum-exp
// lse[n, j] = m_j + log l_j, from which the backward kernel
// (rfm_attention_bwd.cu) recomputes P[i, j] = exp(q_i . k_j - lse_j).
// Ragged L (784 at the 224 train size) is masked on both i and j.
// The launch allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BJ = 64;          // output columns j per block
constexpr int BI = 64;          // rows i per step of the walk
constexpr int THREADS = 256;
constexpr int MAX_C = 32;
constexpr int MAX_D = 384;
constexpr int PAD = 4;          // row pad (floats): conflict-free float4 reads
constexpr int P_STRIDE = BJ + 8;
constexpr int V_STRIDE = MAX_C;
constexpr int ACC = MAX_C / 4;  // accumulator slots per thread

size_t smem_bytes(int d) {
  const size_t row = d + PAD;
  return sizeof(float) * (BJ * row + BI * row + BI * V_STRIDE + BI * P_STRIDE);
}

// Copy rows [r0, r0 + rows) of a (L, d) matrix into shared memory with row
// stride d + PAD; rows past L are zero.
__device__ void load_rows(float* dst, const float* src, int r0, int rows,
                          int l, int d) {
  const int d4 = d / 4;
  const int row = d + PAD;
  for (int e = threadIdx.x; e < rows * d4; e += THREADS) {
    const int r = e / d4;
    const int c = (e - r * d4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < l) {
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * d + c);
    }
    *reinterpret_cast<float4*>(dst + r * row + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
rfm_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int l, int d, int c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row = d + PAD;
  float* ks = smem;                  // (BJ, d + PAD)
  float* qs = ks + BJ * row;         // (BI, d + PAD)
  float* vs = qs + BI * row;         // (BI, V_STRIDE)
  float* ps = vs + BI * V_STRIDE;    // (BI, P_STRIDE): scores, then weights

  const int n = blockIdx.y;
  const int j0 = blockIdx.x * BJ;
  const float* qn = q + (size_t)n * l * d;
  const float* kn = k + (size_t)n * l * d;
  const float* vn = v + (size_t)n * l * c;

  const int tid = threadIdx.x;
  // score micro-tile: rows ty + 16 r, columns tx + 16 s (r, s < 4)
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // softmax and accumulate: column jc, rows sub + 4 r, channels sub + 4 m
  const int jc = tid >> 2;
  const int sub = tid & 3;

  load_rows(ks, kn, j0, BJ, l, d);

  float m_run = -CUDART_INF_F;
  float l_run = 0.f;
  float acc[ACC];
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc[m] = 0.f;

  for (int i0 = 0; i0 < l; i0 += BI) {
    __syncthreads();  // the previous step is done with qs, vs, ps
    load_rows(qs, qn, i0, BI, l, d);
    for (int e = tid; e < BI * c; e += THREADS) {
      const int r = e / c;
      const int ch = e - r * c;
      vs[r * V_STRIDE + ch] = (i0 + r < l) ? vn[(size_t)(i0 + r) * c + ch] : 0.f;
    }
    __syncthreads();

    // scores s[i][j] = q_i . k_j for the 4 x 4 micro-tile
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[r][t] = 0.f;
    for (int e = 0; e < d; e += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * row + e);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        b[t] = *reinterpret_cast<const float4*>(ks + (tx + 16 * t) * row + e);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[r][t] = fmaf(a[r].x, b[t].x, s[r][t]);
          s[r][t] = fmaf(a[r].y, b[t].y, s[r][t]);
          s[r][t] = fmaf(a[r].z, b[t].z, s[r][t]);
          s[r][t] = fmaf(a[r].w, b[t].w, s[r][t]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool valid_i = i0 + ty + 16 * r < l;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ps[(ty + 16 * r) * P_STRIDE + tx + 16 * t] =
            valid_i ? s[r][t] : -CUDART_INF_F;
    }
    __syncthreads();

    // online softmax over i for column jc; four threads share a column
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < BI / 4; ++r)
      tile_max = fmaxf(tile_max, ps[(sub + 4 * r) * P_STRIDE + jc]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_run, tile_max);  // finite: row i0 < l is valid
    const float scale = expf(m_run - m_new);     // 0 on the first step
    float tile_sum = 0.f;
#pragma unroll
    for (int r = 0; r < BI / 4; ++r) {
      float* p = ps + (sub + 4 * r) * P_STRIDE + jc;
      const float w = expf(*p - m_new);          // exp(-inf) = 0 past L
      *p = w;
      tile_sum += w;
    }
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    l_run = l_run * scale + tile_sum;
    m_run = m_new;
#pragma unroll
    for (int m = 0; m < ACC; ++m) acc[m] *= scale;
    __syncthreads();  // every weight of the tile is in ps

    for (int i = 0; i < BI; ++i) {
      const float w = ps[i * P_STRIDE + jc];
#pragma unroll
      for (int m = 0; m < ACC; ++m) {
        const int ch = sub + 4 * m;
        if (ch < c) acc[m] = fmaf(w, vs[i * V_STRIDE + ch], acc[m]);
      }
    }
  }

  const int j = j0 + jc;
  if (j < l) {
    const float inv = 1.f / l_run;
    float* dst = out + ((size_t)n * l + j) * c;
#pragma unroll
    for (int m = 0; m < ACC; ++m) {
      const int ch = sub + 4 * m;
      if (ch < c) dst[ch] = acc[m] * inv;
    }
    if (lse != nullptr && sub == 0) lse[(size_t)n * l + j] = m_run + logf(l_run);
  }
}

}  // namespace

extern "C" {

int rfm_attention_max_c() { return MAX_C; }
int rfm_attention_max_d() { return MAX_D; }

// Launch on `stream`; returns a cudaError_t (0 = launched).  `lse` may be
// null.
int rfm_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int n, int l, int d, int c, void* stream) {
  if (n < 1 || l < 1 || d < 4 || d % 4 != 0 || d > MAX_D || c < 1 || c > MAX_C)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      rfm_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + BJ - 1) / BJ, n);
  rfm_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, l, d, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
