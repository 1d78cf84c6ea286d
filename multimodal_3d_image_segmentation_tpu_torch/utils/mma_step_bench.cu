// The k step of conv3's tensor-core body (csrc/conv3_mma.cu) alone, on a
// CUDA card: how fast mma.sync runs when nothing else is in the way, and
// what each of the step's loads costs. Each warp runs 4000 k steps of a
// 64 x 24 tile (4 M tiles of m16n8k16 against 3 n8 tiles; 'mixed' a second
// pass into accumulators of its own) on blocks that stay resident, so the
// figures carry none of a conv3 block's copies, epilogue or barriers:
//   "hmma only"     the mma.sync on fixed fragments;
//   "+ ldmatrix"    each step's A fragments from shared memory (ldmatrix.x4
//                   at a conflict-free 48-byte slot pitch);
//   "+ B L1"        each step's B fragments loaded one step ahead from a
//                   41 KB buffer a pass that stays in L1;
//   "B from L2"     the same from a 4 MB footprint, one or two steps ahead.
// It prints TFLOP/s of each at 1-4 blocks an SM.
//
// Build and run, from this directory, on a machine with the CUDA toolkit:
//   nvcc -O3 -arch=sm_90a -std=c++17 mma_step_bench.cu -o /tmp/mma_step_bench
//   /tmp/mma_step_bench
#include <cstdio>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
__device__ __forceinline__ void mma_k16(float (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
template <int TM, int NP, int VAR, int PF>
__global__ void __launch_bounds__(256) k(const uint2* w, float* out, int steps) {
  __shared__ __align__(16) unsigned char sm[1000 * 48 + 64];
  for (int i = threadIdx.x; i < (1000 * 48) / 4; i += blockDim.x) reinterpret_cast<unsigned*>(sm)[i] = i * 2654435761u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[NP][TM][3][4] = {};
  unsigned arow[TM];
  for (int mt = 0; mt < TM; ++mt) arow[mt] = (unsigned)__cvta_generic_to_shared(sm) + (((warp * TM + mt) * 16 + (lane & 15)) % 900 * 3 + (lane >> 4)) * 16;
  unsigned af[TM][4];
  for (int mt = 0; mt < TM; ++mt) for (int i = 0; i < 4; ++i) af[mt][i] = lane * 7 + mt + i;
  uint2 b[NP][3], bn[NP][3];
  for (int p = 0; p < NP; ++p) for (int j = 0; j < 3; ++j) b[p][j] = make_uint2(lane + j, p);
  const uint2* bw = w + lane;
  uint2 bn2[NP][3];
  for (int p = 0; p < NP; ++p) for (int j = 0; j < 3; ++j) bn2[p][j] = b[p][j];
  for (int s = 0; s < steps; ++s) {
    // PF 0: 27 taps x 2 k16 steps of B (L1); PF 1: a 4 MB footprint (L2),
    // each warp its own stream
    const long long off = PF == 0 ? (s % 27) * 32 * 3 * 2
        : ((long long)(s * 8 + warp) * 96 + blockIdx.x * 7919LL * 96) % (1 << 19);
    if (VAR == 2) {
      for (int p = 0; p < NP; ++p) for (int j = 0; j < 3; ++j) bn[p][j] = __ldg(bw + off + p * 27 * 192 + j * 32);
    }
    if (VAR == 3) {  // two steps ahead
      for (int p = 0; p < NP; ++p) for (int j = 0; j < 3; ++j) { bn[p][j] = bn2[p][j]; bn2[p][j] = __ldg(bw + off + p * 27 * 192 + j * 32); }
    }
    if (VAR >= 1) {
      const unsigned ao = (s % 27) * 48 + (s & 1) * 32;
      for (int mt = 0; mt < TM; ++mt) ldsm_x4(arow[mt] + ao, af[mt]);
    }
    for (int p = 0; p < NP; ++p)
      for (int mt = 0; mt < TM; ++mt) for (int j = 0; j < 3; ++j) mma_k16(acc[p][mt][j], af[mt], b[p][j]);
    if (VAR >= 2) for (int p = 0; p < NP; ++p) for (int j = 0; j < 3; ++j) b[p][j] = bn[p][j];
  }
  float s = 0; for (int p = 0; p < NP; ++p) for (int mt = 0; mt < TM; ++mt) for (int j = 0; j < 3; ++j) for (int i = 0; i < 4; ++i) s += acc[p][mt][j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int TM, int NP, int VAR, int PF>
void run(const char* name, int threads, int blocks_per_sm, uint2* w, float* out) {
  const int steps = 4000, blocks = 132 * blocks_per_sm;
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  k<TM, NP, VAR, PF><<<blocks, threads>>>(w, out, steps);
  cudaEventRecord(a);
  k<TM, NP, VAR, PF><<<blocks, threads>>>(w, out, steps);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  double flops = 2.0 * blocks * (threads / 32) * (double)steps * NP * TM * 3 * 16 * 8 * 16;
  int regs = 0; cudaFuncAttributes at; cudaFuncGetAttributes(&at, k<TM, NP, VAR, PF>); regs = at.numRegs;
  printf("%-34s thr %3d blk/SM %d regs %3d: %.3f ms, %.1f TFLOP/s (%s)\n", name, threads, blocks_per_sm, regs, ms, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  uint2* w; float* out;
  cudaMalloc(&w, 64 << 20); cudaMemset(w, 0, 64 << 20); cudaMalloc(&out, 132 * 8 * 256 * 4);
  for (int bps : {1, 2}) {
    run<4, 1, 2, 1>("bf16 TM4 B from L2, 1 ahead", 256, bps, w, out);
    run<4, 1, 3, 1>("bf16 TM4 B from L2, 2 ahead", 256, bps, w, out);
    run<4, 2, 2, 1>("mixed TM4 B from L2, 1 ahead", 128, bps * 2, w, out);
    run<4, 2, 3, 1>("mixed TM4 B from L2, 2 ahead", 128, bps * 2, w, out);
  }
  for (int bps : {1, 2, 3, 4}) {
    run<4, 1, 0, 0>("bf16 TM4 hmma only", 256, bps, w, out);
    run<4, 1, 1, 0>("bf16 TM4 + ldmatrix", 256, bps, w, out);
    run<4, 1, 2, 0>("bf16 TM4 + ldmatrix + B L1", 256, bps, w, out);
    run<4, 2, 0, 0>("mixed TM4 hmma only", 128, bps, w, out);
    run<4, 2, 1, 0>("mixed TM4 + ldmatrix", 128, bps, w, out);
    run<4, 2, 2, 0>("mixed TM4 + ldmatrix + B L1", 128, bps, w, out);
    run<2, 1, 2, 0>("bf16 TM2 + ldmatrix + B L1", 256, bps, w, out);
    run<4, 1, 2, 0>("bf16 TM4 + ldmatrix + B L1 128thr", 128, bps * 2, w, out);
  }
  return 0;
}
