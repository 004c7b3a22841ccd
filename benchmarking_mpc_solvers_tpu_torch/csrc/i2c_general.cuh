// The general form of the I2C filter and smoother (kernels 8a/8b): any D and
// Z up to kGeneralMax, past the register form's 6 (ops/i2c_smooth.py:
// kernel_form). Included by i2c_smooth.cu inside its anonymous namespace,
// after the helpers it uses: floor_keep_nan, div_rn, cp_async4,
// cp_async_commit and cp_async_wait.
//
// What held the first general form (a warp a scenario, every matrix in a
// per-warp workspace, the inputs read from device memory inside each dot
// product, a __syncwarp per Cholesky column) at 20-22x its bytes bound at
// D = Z = 9, and what this form does about it:
// - A group of kLanes = 16 lanes per scenario, two scenarios per warp. Lane
//   r owns row r: of sig_p, P J^T, the gain and sig_f in the filter, of
//   M = F sig_f, G, G Dlt and sig_next in the smoother, each row in
//   registers. Rows are compiled for N = 12 or 16 entries (the smallest
//   that holds max(D, Z)); the loops over a sum's index stop at the runtime
//   D or Z (uniform branches), those over a row's entries run to N, and the
//   entries past D or Z are never read into a real one. Lanes past D
//   compute a copy of row D - 1 (rows past Z of sig_y) and store nothing.
// - Every sum a lane forms has the row's other factor in registers and
//   reads the shared factor as rows of a matrix in shared memory, four
//   floats a load, the same address for the group's lanes. So each product
//   is laid out by the index it sums over: F and J are staged transposed,
//   P J^T is kept both ways, L both ways, G by columns.
// - The horizon's inputs are staged a step ahead by 4-byte cp.async into a
//   ring of two slots per scenario (the filter's F and J, the smoother's
//   sig_f, sig_pred and mu_pred), waited on with the step's last barrier.
//   The rest of a step's inputs (m, z0, g_z, R, the smoother's own row of F
//   and mu_f) are single entries or a lane's own row, loaded from device
//   memory when the step starts. TMA is not used: slabs are only 4-byte
//   aligned (i2c_smooth.cu's design notes).
// - The Cholesky factorisation of sig_y (the smoother's sig_pred) runs with
//   rows in registers: lane j forms the diagonal of column j, one shuffle
//   takes it to the group, each lane divides its own entry, and the column
//   goes to the lanes that update with it by shuffles; no shared memory and
//   no barrier inside it. Each lane then solves its own row by forward and
//   backward substitution against the factor in shared memory.
// - A filter step takes four __syncwarp, a smoother step three. The
//   smoother's gain does not depend on its carry: the warps in flight hide
//   the factorisation and the solves, which run in the same step as the
//   recurrence.
// Every entry is one lane's sum in the plain version's order, with its
// operations, so this form keeps the plain version's bits at every size.
// Groups past B compute on the last scenario's inputs and store nothing, so
// every lane takes part in every shuffle and barrier.
//
// On an H100 (80GB HBM3, 700 W) at B = 10240, T = 50: 1.35-1.46 ms for the
// filter and 0.96-0.99 ms for the smoother at D = Z = 9 (the first general
// form: 4.74-5.19 and 3.22), 5.29-5.36 and 3.11-3.26 ms at D = Z = 16
// (22.8 and 11.6), against bytes bounds of 0.221 and 0.165 ms, 0.668 and
// 0.499 ms at 3.35 TB/s. Shared memory sets the blocks an SM holds: 10 of
// 2 warps at rows of 12, 6 and 5 at rows of 16.

constexpr int kLanes = 16;            // lanes per scenario
constexpr int kGeneralMax = 16;       // the largest D and Z of this form
constexpr int kGeneralWarps = 2;      // warps per block
constexpr unsigned kFullMask = 0xffffffffu;

// Row stride of a matrix whose rows the lanes write or read as their own,
// four floats a time: at 4 mod 8 floats the 8 lanes of a quarter warp meet
// 8 different groups of 4 banks.
__host__ __device__ constexpr int own_stride(int n) { return n % 8 == 0 ? n + 4 : n; }
// A scenario's floats, padded to 16 mod 32: the two groups of a warp then
// sit in opposite halves of the banks.
__host__ __device__ constexpr int scenario_stride(int n) { return n + ((16 - n % 32) % 32 + 32) % 32; }

template <int N>
struct GeneralFilterLayout {
  static constexpr int kRow = own_stride(N);
  // a ring slot: F^T and J^T of one step (row k holds column k, N entries)
  static constexpr int kFT = 0, kJT = N * N, kSlot = 2 * N * N;
  // scratch: P J^T by rows (then sf), by columns; L by rows (then sig_f), by
  // columns; mu_p, mu_f and the innovation
  static constexpr int kPJ = 2 * kSlot, kPJT = kPJ + N * kRow, kL = kPJT + N * N,
                       kLT = kL + N * kRow, kMP = kLT + N * N, kMF = kMP + N, kIN = kMF + N,
                       kScenFloats = scenario_stride(kIN + N);
  // the block: Q by rows, then its scenarios
  static constexpr int kQ = N * kRow;
  static constexpr int kThreads = 32 * kGeneralWarps, kScen = kThreads / kLanes, kChunk = 1;
  static constexpr int kBytes = (kQ + kScen * kScenFloats) * (int)sizeof(float);
  static_assert(kBytes <= 48 * 1024, "the general filter's blocks launch with default shared memory");
};

template <int N>
struct GeneralRtsLayout {
  static constexpr int kRow = own_stride(N);
  // a ring slot: sig_f and sig_pred by rows, mu_pred
  static constexpr int kSf = 0, kSp = N * kRow, kMp = 2 * N * kRow, kSlot = kMp + N;
  // scratch: M = F sig_f by rows, L by rows and by columns, G by columns,
  // sig_next by rows, mu_next
  static constexpr int kM = 2 * kSlot, kL = kM + N * kRow, kLT = kL + N * kRow,
                       kGT = kLT + N * N, kSN = kGT + N * N, kMN = kSN + N * kRow,
                       kScenFloats = scenario_stride(kMN + N);
  static constexpr int kThreads = 32 * kGeneralWarps, kScen = kThreads / kLanes, kChunk = 1;
  static constexpr int kBytes = kScen * kScenFloats * (int)sizeof(float);
  static_assert(kBytes <= 48 * 1024, "the general smoother's blocks launch with default shared memory");
};

// v[0..N) from a 16-byte aligned row of shared memory, four floats a load.
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// v's entries [lo, hi) (and their neighbours in the same four) from such a
// row; lo and hi are constants once the caller's loop is unrolled.
template <int N>
__device__ __forceinline__ void load_part(float (&v)[N], const float* p, int lo, int hi) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    if (4 * q + 4 > lo && 4 * q < hi) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// a[0..N) = 0 + sum over k < n of x[k] * rows[k][0..N), each entry's sum in
// the order of k: the rows (stride S) read four floats a load.
template <int N, int S>
__device__ __forceinline__ void row_times(float (&a)[N], const float (&x)[N], const float* rows,
                                          int n) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= n) break;
    float v[N];
    load_row<N>(v, rows + k * S);
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = a[j] + x[k] * v[j];
  }
}

// The lower Cholesky factor of an n x n matrix whose row r is this lane's
// a[] (entries past r unused), in place: a[c] becomes L[r][c] for c <= r.
// Column j: lane j's diagonal, one shuffle to the group, each lane's
// division, then the column by shuffles to the updates of the later ones,
// each entry's subtractions in the order of j.
template <int N>
__device__ __forceinline__ void chol_rows(float (&a)[N], int n, int r) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j >= n) break;
    const float d = __shfl_sync(kFullMask, sqrtf(floor_keep_nan(a[j])), j, kLanes);
    const float l = div_rn(a[j], d);
    a[j] = r == j ? d : l;
#pragma unroll
    for (int c = j + 1; c < N; ++c) {
      if (c >= n) break;
      const float lc = __shfl_sync(kFullMask, l, c, kLanes);
      a[c] = a[c] - l * lc;
    }
  }
}

// b = (L L^T)^-1 b for the n x n factor whose rows are at Lr (stride S) and
// whose columns are at Lc (stride N): forward then backward substitution.
template <int N, int S>
__device__ __forceinline__ void chol_solve_rows(float (&b)[N], const float* Lr, const float* Lc,
                                                int n) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= n) break;
    float row[N];
    load_part<N>(row, Lr + i * S, 0, i + 1);
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - row[k] * b[k];
    b[i] = div_rn(s, row[i]);
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    if (i >= n) continue;
    float col[N];
    load_part<N>(col, Lc + i * N, i, n);
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) {
      if (k >= n) break;
      s = s - col[k] * b[k];
    }
    b[i] = div_rn(s, col[i]);
  }
}

// Step t's F and J into a ring slot, transposed: F^T[k][i] = F[i][k], J^T[k][a]
// = J[a][k]; lane r copies entry r of each row of F^T and J^T.
template <int N>
__device__ __forceinline__ void general_filter_stage(float* slot, const float* Fbt,
                                                     const float* Jbt, int D, int Z, int r) {
  float* FT = slot + GeneralFilterLayout<N>::kFT;
  float* JT = slot + GeneralFilterLayout<N>::kJT;
#pragma unroll 1
  for (int k = 0; k < D; ++k) {
    if (r < D) cp_async4(FT + k * N + r, Fbt + r * D + k);
    if (r < Z) cp_async4(JT + k * N + r, Jbt + r * D + k);
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(32 * kGeneralWarps)
i2c_filter_general(const float* __restrict__ F, const float* __restrict__ m,
                   const float* __restrict__ J, const float* __restrict__ z0,
                   const float* __restrict__ R, int r_stride,
                   const float* __restrict__ mu0, const float* __restrict__ sig0,
                   const float* __restrict__ Qproc, const float* __restrict__ g_z,
                   float* __restrict__ mu_f_out, float* __restrict__ sig_f_out,
                   float* __restrict__ mu_pred_out, float* __restrict__ sig_pred_out,
                   int B, int T, int D, int Z) {
  using L = GeneralFilterLayout<N>;
  constexpr int S = L::kRow;
  extern __shared__ float smem[];
  const int r = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
  const int b = blockIdx.x * L::kScen + g;
  const int bc = min(b, B - 1);
  const bool live = b < B && r < D;
  const int row = min(r, D - 1), arow = min(r, Z - 1);  // this lane's row of D, of Z
  float* sQ = smem;
  float* sc = smem + L::kQ + g * L::kScenFloats;
  float *sPJ = sc + L::kPJ, *sPJT = sc + L::kPJT, *sL = sc + L::kL, *sLT = sc + L::kLT;
  float *sMP = sc + L::kMP, *sMF = sc + L::kMF, *sIN = sc + L::kIN;
  const size_t bT = (size_t)bc * T;

  general_filter_stage<N>(sc, F + bT * D * D, J + bT * Z * D, D, Z, r);
  for (int e = threadIdx.x; e < D * D; e += L::kThreads) sQ[(e / D) * S + e % D] = Qproc[e];
  float p[N], mu_p = mu0[(size_t)bc * D + row];
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = j < D ? sig0[row * D + j] : 0.0f;
  if (r < D) sMP[r] = mu_p;
  cp_async_wait<0>();
  __syncthreads();  // Q, mu_0 and step 0's slot

  for (int t = 0; t < T; ++t) {
    const size_t bt = bT + t;
    const float* sFT = sc + (t & 1) * L::kSlot + L::kFT;
    const float* sJT = sc + (t & 1) * L::kSlot + L::kJT;
    const float z0a = z0[bt * Z + arow], ga = g_z[(size_t)t * Z + arow], mi = m[bt * D + row];
    // own row of P J^T
    float pj[N];
    row_times<N, N>(pj, p, sJT, D);
    if (r < D) {
      store_row<N>(sPJ + r * S, pj);
#pragma unroll
      for (int a = 0; a < N; ++a) sPJT[a * N + r] = pj[a];
    }
    __syncwarp();
    if (t + 1 < T)
      general_filter_stage<N>(sc + ((t + 1) & 1) * L::kSlot, F + (bt + 1) * D * D,
                              J + (bt + 1) * Z * D, D, Z, r);
    // own row of J; the innovation g - (J mu_p + z0); own row of sig_y =
    // R + J P J^T, factored across the group
    float jr[N];
#pragma unroll
    for (int k = 0; k < N; ++k) jr[k] = k < D ? sJT[k * N + arow] : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= D) break;
      s = s + jr[k] * sMP[k];
    }
    const float innov = ga - (s + z0a);
    float sy[N];
    row_times<N, S>(sy, jr, sPJ, D);
    const float* Ra = R + (size_t)bc * r_stride + arow * Z;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c >= Z) break;
      sy[c] = Ra[c] + sy[c];
    }
    chol_rows<N>(sy, Z, r);
    if (r < Z) {
      store_row<N>(sL + r * S, sy);
#pragma unroll
      for (int c = 0; c < N; ++c) sLT[c * N + r] = sy[c];
      sIN[r] = innov;
    }
    __syncwarp();
    // own gain row: sig_y x = (P J^T)[row]; mu_f = mu_p + L innov; sf =
    // sig_p - L (P J^T)^T, into P J^T's rows
    chol_solve_rows<N, S>(pj, sL, sLT, Z);
    s = 0.0f;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (a >= Z) break;
      s = s + pj[a] * sIN[a];
    }
    const float mf = mu_p + s;
    float sf[N];
    row_times<N, N>(sf, pj, sPJT, Z);
#pragma unroll
    for (int j = 0; j < N; ++j) sf[j] = p[j] - sf[j];
    if (r < D) {
      store_row<N>(sPJ + r * S, sf);
      sMF[r] = mf;
    }
    __syncwarp();
    // sig_f = sym(sf), into L's rows
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j >= D) break;
      sf[j] = 0.5f * (sf[j] + sPJ[j * S + row]);
    }
    if (r < D) store_row<N>(sL + r * S, sf);
    if (live) {
      mu_f_out[bt * D + r] = mf;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j >= D) break;
        sig_f_out[(bt * D + r) * D + j] = sf[j];
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // sig_f, mu_f, and step t+1's slot
    // predict: own entry of m + F mu_f, own row of (F sig_f) F^T + Q
    float fr[N];
#pragma unroll
    for (int k = 0; k < N; ++k) fr[k] = k < D ? sFT[k * N + row] : 0.0f;
    float fs[N];
    row_times<N, S>(fs, fr, sL, D);
    s = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= D) break;
      s = s + fr[k] * sMF[k];
    }
    mu_p = mi + s;
    row_times<N, N>(p, fs, sFT, D);
    {
      float q[N];
      load_row<N>(q, sQ + row * S);
#pragma unroll
      for (int j = 0; j < N; ++j) p[j] = p[j] + q[j];
    }
    if (r < D) sMP[r] = mu_p;
    if (live) {
      mu_pred_out[bt * D + r] = mu_p;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j >= D) break;
        sig_pred_out[(bt * D + r) * D + j] = p[j];
      }
    }
  }
}

// Step t's sig_f, sig_pred (by rows) and mu_pred into a ring slot; lane r
// copies entry r of each row.
template <int N>
__device__ __forceinline__ void general_rts_stage(float* slot, const float* sig_f_bt,
                                                  const float* sig_pred_bt,
                                                  const float* mu_pred_bt, int D, int r) {
  using L = GeneralRtsLayout<N>;
  if (r < D) {
#pragma unroll 1
    for (int i = 0; i < D; ++i) {
      cp_async4(slot + L::kSf + i * L::kRow + r, sig_f_bt + i * D + r);
      cp_async4(slot + L::kSp + i * L::kRow + r, sig_pred_bt + i * D + r);
    }
    cp_async4(slot + L::kMp + r, mu_pred_bt + r);
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(32 * kGeneralWarps)
i2c_rts_general(const float* __restrict__ mu_f, const float* __restrict__ sig_f,
                const float* __restrict__ mu_pred, const float* __restrict__ sig_pred,
                const float* __restrict__ F, float* __restrict__ mu_s, int B, int T, int D) {
  using L = GeneralRtsLayout<N>;
  constexpr int S = L::kRow;
  extern __shared__ float smem[];
  const int r = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
  const int b = blockIdx.x * L::kScen + g;
  const int bc = min(b, B - 1);
  const bool live = b < B && r < D;
  const int row = min(r, D - 1);
  float* sc = smem + g * L::kScenFloats;
  float *sM = sc + L::kM, *sL = sc + L::kL, *sLT = sc + L::kLT, *sGT = sc + L::kGT;
  float *sSN = sc + L::kSN, *sMN = sc + L::kMN;
  const size_t bT = (size_t)bc * T, DD = (size_t)D * D;

  // the carry starts from the filtered moments of t = T-1, the last output row
  {
    const size_t bl = bT + T - 1;
    float sn[N];
#pragma unroll
    for (int j = 0; j < N; ++j) sn[j] = j < D ? sig_f[(bl * D + row) * D + j] : 0.0f;
    const float mn = mu_f[bl * D + row];
    if (r < D) {
      store_row<N>(sSN + r * S, sn);
      sMN[r] = mn;
    }
    if (live) mu_s[bl * D + r] = mn;
  }
  if (T > 1)
    general_rts_stage<N>(sc, sig_f + (bT + T - 2) * DD, sig_pred + (bT + T - 2) * DD,
                         mu_pred + (bT + T - 2) * D, D, r);

  for (int t = T - 2, n = 0; t >= 0; --t, ++n) {
    const size_t bt = bT + t;
    const float* slot = sc + (n & 1) * L::kSlot;
    const float *sSf = slot + L::kSf, *sSp = slot + L::kSp, *sMp = slot + L::kMp;
    float fr[N];
#pragma unroll
    for (int k = 0; k < N; ++k) fr[k] = k < D ? F[(bt * D + row) * D + k] : 0.0f;
    const float muf = mu_f[bt * D + row];
    cp_async_wait<0>();
    __syncwarp();  // step t's slot, and the carry
    // own row of M = F sig_f; own row of sig_pred, factored across the group
    float mm[N];
    row_times<N, S>(mm, fr, sSf, D);
    float a[N];
    load_row<N>(a, sSp + row * S);
    chol_rows<N>(a, D, r);
    if (r < D) {
      store_row<N>(sM + r * S, mm);
      store_row<N>(sL + r * S, a);
#pragma unroll
      for (int c = 0; c < N; ++c) sLT[c * N + r] = a[c];
    }
    __syncwarp();
    if (t > 0)
      general_rts_stage<N>(sc + ((n + 1) & 1) * L::kSlot, sig_f + (bt - 1) * DD,
                           sig_pred + (bt - 1) * DD, mu_pred + (bt - 1) * D, D, r);
    // own row of G: sig_pred x = M[:, row]; the smoothed mean; own row of
    // G (sig_next - sig_pred)
    float gr[N];
#pragma unroll
    for (int k = 0; k < N; ++k) gr[k] = k < D ? sM[k * S + row] : 0.0f;
    chol_solve_rows<N, S>(gr, sL, sLT, D);
    if (r < D) {
#pragma unroll
      for (int k = 0; k < N; ++k) sGT[k * N + r] = gr[k];
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= D) break;
      s = s + gr[k] * (sMN[k] - sMp[k]);
    }
    const float ms = muf + s;
    float gd[N];
#pragma unroll
    for (int j = 0; j < N; ++j) gd[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= D) break;
      float vn[N], vp[N];
      load_row<N>(vn, sSN + k * S);
      load_row<N>(vp, sSp + k * S);
#pragma unroll
      for (int j = 0; j < N; ++j) gd[j] = gd[j] + gr[k] * (vn[j] - vp[j]);
    }
    __syncwarp();  // G, and every read of the carry
    // own row of sig_next = sig_f + G Dlt G^T, and the mean carried
    float sn[N];
    row_times<N, N>(sn, gd, sGT, D);
    {
      float v[N];
      load_row<N>(v, sSf + row * S);
#pragma unroll
      for (int j = 0; j < N; ++j) sn[j] = v[j] + sn[j];
    }
    if (r < D) {
      store_row<N>(sSN + r * S, sn);
      sMN[r] = ms;
    }
    if (live) mu_s[bt * D + r] = ms;
  }
}
