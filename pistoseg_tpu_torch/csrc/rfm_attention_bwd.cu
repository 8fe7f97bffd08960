// Fused RFM affinity attention, backward, for Hopper (sm_90a).
//
// Forward (rfm_attention.cu), per image n:
//   P[i, j] = softmax_i(q_i . k_j) = exp(q_i . k_j - lse_j),
//   out[j, c] = sum_i P[i, j] v[i, c].
// For the upstream gradient g = dL/dout this computes
//   D_j      = sum_c g[j, c] out[j, c]          (= sum_i P[i, j] dP[i, j])
//   dP[i, j] = sum_c v[i, c] g[j, c]
//   dS[i, j] = P[i, j] (dP[i, j] - D_j)
//   dv_i = sum_j P[i, j] g_j,  dq_i = sum_j dS[i, j] k_j,  dk_j = sum_i dS[i, j] q_i.
// Replaces the JAX package's backward of the custom VJP around the TPU
// kernel, pistoseg_tpu/ops/pallas/rfm_attention.py::_rfm_bwd (an XLA
// recompute that materialises the L x L affinity); no Pallas kernel
// existed for it.  Here the affinity never reaches device memory: P is
// recomputed tile by tile from q, k and the forward's lse.
//
// Design.  Two passes with no atomics, so every gradient is a fixed-order
// sum and bit-deterministic from run to run.
//   Pass A, one block per (image n, tile of BI rows i): walks j in tiles
//     of BJ, recomputes the BI x BJ tile of P and dS, and accumulates
//     dq_i (registers, 4 rows x 4*DCH columns a thread) and dv_i.
//   Pass B, one block per (image n, tile of BJ columns j): walks i in
//     tiles of BI, recomputes dS, and accumulates dk_j.
// Scores, dP and the sums are IEEE float32 FMAs: no TF32, because the
// Pallas kernel pins Precision.HIGHEST (bf16 rounding moved scores by
// ~4e-2).  Ragged L (784 at the 224 train size) is masked on both axes:
// rows i >= L get P = 0, columns j >= L get lse = +inf, so P = 0.
//
// Bound on an H100 SXM.  The function needs S, dP, dv, dq and dk once:
// 2 L^2 (3D + 2C) FLOP per image, plus L^2 exp; at N=16, L=784, D=192,
// C=12 that is 11.8 GFLOP, 0.18 ms at the datasheet's 67 TFLOP/s of
// non-tensor FP32.  It reads ~21 MB and writes ~20 MB, 12 us at 3.35 TB/s,
// so it is bound by the FP32 pipes.  The two passes recompute S and dP:
// 2 L^2 (4D + 3C) FLOP, a third more than the bound counts.  This simple
// version does not reach that bound either; tensor cores (3xTF32) are the
// lever for a later version.
//
// Shapes: q, k, dq, dk (N, L, D) f32 contiguous, D % 4 == 0, D <= MAX_D;
// v, out, g, dv (N, L, C) f32 contiguous, 1 <= C <= MAX_C; lse (N, L) f32.
// The launch allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BI = 64;            // rows i per tile
constexpr int BJ = 64;            // columns j per tile
constexpr int THREADS = 256;
constexpr int MAX_C = 32;
constexpr int MAX_D = 256;
constexpr int PAD = 4;            // row pad (floats): conflict-free float4 reads
constexpr int P_STRIDE = BJ + 8;  // (BI, BJ) tiles of P and dS
constexpr int C_STRIDE = MAX_C + 1;  // v and g rows: 16 rows read on 16 banks
constexpr int ACC = MAX_C / 4;    // dv slots per thread
static_assert(BI == 64 && BJ == 64, "accumulate_rows walks 64 staged rows");

size_t smem_pass_a(int d) {
  const size_t row = d + PAD;
  return sizeof(float) * (BI * row + BJ * row + (BI + BJ) * C_STRIDE +
                          2 * BI * P_STRIDE + 2 * BJ);
}

size_t smem_pass_b(int d) {
  const size_t row = d + PAD;
  return sizeof(float) * (BI * row + BJ * row + (BI + BJ) * C_STRIDE +
                          BI * P_STRIDE + 2 * BJ);
}

// Rows [r0, r0 + rows) of a (L, d) matrix into shared memory with row
// stride d + PAD; rows past L are zero.
__device__ void load_rows(float* dst, const float* src, int r0, int rows,
                          int l, int d) {
  const int d4 = d / 4;
  const int row = d + PAD;
  for (int e = threadIdx.x; e < rows * d4; e += THREADS) {
    const int r = e / d4;
    const int col = (e - r * d4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < l) {
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * d + col);
    }
    *reinterpret_cast<float4*>(dst + r * row + col) = val;
  }
}

// Rows [r0, r0 + rows) of a (L, c) matrix with row stride C_STRIDE; rows
// past L are zero.
__device__ void load_narrow(float* dst, const float* src, int r0, int rows,
                            int l, int c) {
  for (int e = threadIdx.x; e < rows * c; e += THREADS) {
    const int r = e / c;
    const int ch = e - r * c;
    dst[r * C_STRIDE + ch] = (r0 + r < l) ? src[(size_t)(r0 + r) * c + ch] : 0.f;
  }
}

// lse_j and D_j = sum_c g[j, c] out[j, c] for the BJ columns from j0; a
// column past L gets lse = +inf, so its P is exp(-inf) = 0.
__device__ void load_columns(float* lse_s, float* dj_s, const float* lse,
                             const float* g, const float* out, int j0, int l,
                             int c) {
  const int t = threadIdx.x;
  if (t < BJ) {
    const int j = j0 + t;
    float dj = 0.f;
    float lj = CUDART_INF_F;
    if (j < l) {
      lj = lse[j];
      for (int ch = 0; ch < c; ++ch)
        dj = fmaf(g[(size_t)j * c + ch], out[(size_t)j * c + ch], dj);
    }
    lse_s[t] = lj;
    dj_s[t] = dj;
  }
}

// The BI x BJ tiles of P and dS for the staged rows i (qs, vs) and columns
// j (ks, gs, lse_s, dj_s).  Thread (tx, ty) owns rows ty + 16 r and
// columns tx + 16 t, r, t < 4.  Rows at or past `rows_valid` get P = 0.
// ps may be null (pass B needs only dS).
__device__ void p_ds_tile(const float* qs, const float* ks, const float* vs,
                          const float* gs, const float* lse_s,
                          const float* dj_s, int rows_valid, int d, int c,
                          float* ps, float* dss) {
  const int row = d + PAD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) s[r][t] = dp[r][t] = 0.f;
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
  for (int ch = 0; ch < c; ++ch) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = vs[(ty + 16 * r) * C_STRIDE + ch];
#pragma unroll
    for (int t = 0; t < 4; ++t) b[t] = gs[(tx + 16 * t) * C_STRIDE + ch];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) dp[r][t] = fmaf(a[r], b[t], dp[r][t]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = tx + 16 * t;
      const float p = (i < rows_valid) ? expf(s[r][t] - lse_s[j]) : 0.f;
      if (ps != nullptr) ps[i * P_STRIDE + j] = p;
      dss[i * P_STRIDE + j] = p * (dp[r][t] - dj_s[j]);
    }
  }
}

// acc[r][s] += sum_x w(x, ty + 16 r) * m[x, 4 tx + 64 s ..+3] over the 64
// staged rows x of m: rows of dq (w = dS[i, x], m = k) in pass A, rows of
// dk (w = dS[x, j], m = q) in pass B.  `w_x` and `w_own` are the strides
// of the weight tile along x and along the owned index.
template <int DCH>
__device__ void accumulate_rows(float4 (&acc)[4][DCH], const float* wts,
                                int w_x, int w_own, const float* m, int d) {
  const int row = d + PAD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int x = 0; x < BI; ++x) {
    float w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = wts[x * w_x + (ty + 16 * r) * w_own];
#pragma unroll
    for (int s = 0; s < DCH; ++s) {
      const int col = 4 * tx + 64 * s;
      if (col < d) {
        const float4 b = *reinterpret_cast<const float4*>(m + x * row + col);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][s].x = fmaf(w[r], b.x, acc[r][s].x);
          acc[r][s].y = fmaf(w[r], b.y, acc[r][s].y);
          acc[r][s].z = fmaf(w[r], b.z, acc[r][s].z);
          acc[r][s].w = fmaf(w[r], b.w, acc[r][s].w);
        }
      }
    }
  }
}

// Rows r0 + ty + 16 r (< L) of a (L, d) output from the register tile.
template <int DCH>
__device__ void store_rows(float* dst, const float4 (&acc)[4][DCH], int r0,
                           int l, int d) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rr = r0 + ty + 16 * r;
    if (rr >= l) continue;
#pragma unroll
    for (int s = 0; s < DCH; ++s) {
      const int col = 4 * tx + 64 * s;
      if (col < d)
        *reinterpret_cast<float4*>(dst + (size_t)rr * d + col) = acc[r][s];
    }
  }
}

template <int DCH>
__global__ void __launch_bounds__(THREADS)
pass_a_dq_dv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ out,
             const float* __restrict__ lse, const float* __restrict__ g,
             float* __restrict__ dq, float* __restrict__ dv, int l, int d,
             int c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row = d + PAD;
  float* qs = smem;                   // (BI, row): this block's rows i
  float* ks = qs + BI * row;          // (BJ, row): the current columns j
  float* vs = ks + BJ * row;          // (BI, C_STRIDE)
  float* gs = vs + BI * C_STRIDE;     // (BJ, C_STRIDE)
  float* ps = gs + BJ * C_STRIDE;     // (BI, P_STRIDE): P
  float* dss = ps + BI * P_STRIDE;    // (BI, P_STRIDE): dS
  float* lse_s = dss + BI * P_STRIDE; // (BJ)
  float* dj_s = lse_s + BJ;           // (BJ)

  const int n = blockIdx.y;
  const int i0 = blockIdx.x * BI;
  const size_t nd = (size_t)n * l * d;
  const size_t nc = (size_t)n * l * c;
  const int tid = threadIdx.x;
  // dv: row iv, channels sub + 4 m
  const int iv = tid >> 2;
  const int sub = tid & 3;

  load_rows(qs, q + nd, i0, BI, l, d);
  load_narrow(vs, v + nc, i0, BI, l, c);

  float4 acc[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < DCH; ++s) acc[r][s] = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc_v[ACC];
#pragma unroll
  for (int m = 0; m < ACC; ++m) acc_v[m] = 0.f;

  for (int j0 = 0; j0 < l; j0 += BJ) {
    __syncthreads();  // the previous step is done with ks, gs, ps, dss
    load_rows(ks, k + nd, j0, BJ, l, d);
    load_narrow(gs, g + nc, j0, BJ, l, c);
    load_columns(lse_s, dj_s, lse + (size_t)n * l, g + nc, out + nc, j0, l, c);
    __syncthreads();
    p_ds_tile(qs, ks, vs, gs, lse_s, dj_s, l - i0, d, c, ps, dss);
    __syncthreads();
    // dq_i += sum_j dS[i, j] k_j
    accumulate_rows<DCH>(acc, dss, 1, P_STRIDE, ks, d);
    // dv_i += sum_j P[i, j] g_j
    for (int j = 0; j < BJ; ++j) {
      const float w = ps[iv * P_STRIDE + j];
#pragma unroll
      for (int m = 0; m < ACC; ++m) {
        const int ch = sub + 4 * m;
        if (ch < c) acc_v[m] = fmaf(w, gs[j * C_STRIDE + ch], acc_v[m]);
      }
    }
  }

  store_rows<DCH>(dq + nd, acc, i0, l, d);
  if (i0 + iv < l) {
    float* dst = dv + nc + (size_t)(i0 + iv) * c;
#pragma unroll
    for (int m = 0; m < ACC; ++m) {
      const int ch = sub + 4 * m;
      if (ch < c) dst[ch] = acc_v[m];
    }
  }
}

template <int DCH>
__global__ void __launch_bounds__(THREADS)
pass_b_dk(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ out,
          const float* __restrict__ lse, const float* __restrict__ g,
          float* __restrict__ dk, int l, int d, int c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row = d + PAD;
  float* ks = smem;                   // (BJ, row): this block's columns j
  float* qs = ks + BJ * row;          // (BI, row): the current rows i
  float* gs = qs + BI * row;          // (BJ, C_STRIDE)
  float* vs = gs + BJ * C_STRIDE;     // (BI, C_STRIDE)
  float* dss = vs + BI * C_STRIDE;    // (BI, P_STRIDE): dS
  float* lse_s = dss + BI * P_STRIDE; // (BJ)
  float* dj_s = lse_s + BJ;           // (BJ)

  const int n = blockIdx.y;
  const int j0 = blockIdx.x * BJ;
  const size_t nd = (size_t)n * l * d;
  const size_t nc = (size_t)n * l * c;

  load_rows(ks, k + nd, j0, BJ, l, d);
  load_narrow(gs, g + nc, j0, BJ, l, c);
  load_columns(lse_s, dj_s, lse + (size_t)n * l, g + nc, out + nc, j0, l, c);

  float4 acc[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < DCH; ++s) acc[r][s] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i0 = 0; i0 < l; i0 += BI) {
    __syncthreads();  // the previous step is done with qs, vs, dss
    load_rows(qs, q + nd, i0, BI, l, d);
    load_narrow(vs, v + nc, i0, BI, l, c);
    __syncthreads();
    p_ds_tile(qs, ks, vs, gs, lse_s, dj_s, l - i0, d, c, nullptr, dss);
    __syncthreads();
    // dk_j += sum_i dS[i, j] q_i
    accumulate_rows<DCH>(acc, dss, P_STRIDE, 1, qs, d);
  }

  store_rows<DCH>(dk + nd, acc, j0, l, d);
}

template <int DCH>
int launch(const float* q, const float* k, const float* v, const float* out,
           const float* lse, const float* g, float* dq, float* dk, float* dv,
           int n, int l, int d, int c, cudaStream_t stream) {
  const size_t smem_a = smem_pass_a(d);
  const size_t smem_b = smem_pass_b(d);
  cudaError_t err = cudaFuncSetAttribute(
      pass_a_dq_dv<DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      pass_b_dk<DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a((l + BI - 1) / BI, n);
  pass_a_dq_dv<DCH><<<grid_a, THREADS, smem_a, stream>>>(q, k, v, out, lse, g,
                                                         dq, dv, l, d, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((l + BJ - 1) / BJ, n);
  pass_b_dk<DCH><<<grid_b, THREADS, smem_b, stream>>>(q, k, v, out, lse, g,
                                                      dk, l, d, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rfm_attention_bwd_max_c() { return MAX_C; }
int rfm_attention_bwd_max_d() { return MAX_D; }

// Launch both passes on `stream`; returns a cudaError_t (0 = launched).
int rfm_attention_bwd(const void* q, const void* k, const void* v,
                      const void* out, const void* lse, const void* g,
                      void* dq, void* dk, void* dv, int n, int l, int d, int c,
                      void* stream) {
  if (n < 1 || l < 1 || d < 4 || d % 4 != 0 || d > MAX_D || c < 1 || c > MAX_C)
    return (int)cudaErrorInvalidValue;
  const float* args[] = {(const float*)q, (const float*)k, (const float*)v,
                         (const float*)out, (const float*)lse, (const float*)g};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 63) / 64) {
    case 1: return launch<1>(args[0], args[1], args[2], args[3], args[4], args[5],
                             (float*)dq, (float*)dk, (float*)dv, n, l, d, c, s);
    case 2: return launch<2>(args[0], args[1], args[2], args[3], args[4], args[5],
                             (float*)dq, (float*)dk, (float*)dv, n, l, d, c, s);
    case 3: return launch<3>(args[0], args[1], args[2], args[3], args[4], args[5],
                             (float*)dq, (float*)dk, (float*)dv, n, l, d, c, s);
    default: return launch<4>(args[0], args[1], args[2], args[3], args[4], args[5],
                              (float*)dq, (float*)dk, (float*)dv, n, l, d, c, s);
  }
}

}  // extern "C"
